"""The examples of ``examples/`` on the PyTorch port (``skeres_tpu_torch``),
under the same names. Each runs on the card unless asked for the CPU
(``main(device="cpu")``, or ``--device cpu`` where the script takes flags):

    python -m examples_torch.powell --device cpu
"""
