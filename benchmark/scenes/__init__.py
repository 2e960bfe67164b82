"""Scene generators, one module a scene kind, found by the configuration's ``generator``."""
