"""Console entry points of the port (reference: the gflags example
binaries ``examples/bundle_adjuster.cc`` and ``examples/slam/pose_graph_{2d,3d}``
of the Ceres lineage), the counterparts of ``skeres_tpu.cli``. Each runs on
the card unless given ``--device cpu``. Run as modules:

    python -m skeres_tpu_torch.cli.bundle_adjuster --input data/problem-49.txt \
        --linear_solver DENSE_SCHUR --robustify
    python -m skeres_tpu_torch.cli.pose_graph_3d --num_poses 2500
    python -m skeres_tpu_torch.cli.pose_graph_2d --input graph.g2o
"""
