#!/usr/bin/env python
"""Shim: see `python -m skeres_tpu_torch.cli.pose_graph_3d`."""

from skeres_tpu_torch.cli.pose_graph_3d import main

if __name__ == "__main__":
    main()
