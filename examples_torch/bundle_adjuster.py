#!/usr/bin/env python
"""Shim: see `python -m skeres_tpu_torch.cli.bundle_adjuster`."""

from skeres_tpu_torch.cli.bundle_adjuster import main

if __name__ == "__main__":
    main()
