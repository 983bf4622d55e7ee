"""CUDA graph captures made inside the window: the change of
``ExecutorKernels.captures`` across it. Set-up captures every step the
cell's traffic can ask for, so a capture here is a step the set-up missed,
paid for inside a prefill iteration."""


def read(run):
    return float(run.window.captures)
