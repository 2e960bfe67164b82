"""setup_s: process start to the window's start: the imports, the kernels
built or found, the scene drawn on the card, the warm-up solve."""


def read(rec):
    return rec["window"]["setup_s"]
