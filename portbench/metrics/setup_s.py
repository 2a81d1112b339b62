"""setup_s: from process start to the first timed frame: the interpreter,
torch, the CUDA context, the kernel library, the scene build and upload,
and the warm-up."""


def read(run):
    return run.setup_s
