"""`python -m skeres_tpu_torch.cli` — list the available command-line tools."""

print(__import__("skeres_tpu_torch.cli", fromlist=["__doc__"]).__doc__)
