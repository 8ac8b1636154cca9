"""Set-up (s): from the process's start (the kernel's record of it) to the
window's start: imports, the kernels' library (built by the first run in a
checkout), the weights, the engine and its warm-up (every prompt bucket
admitted once, the decode programs captured), the server, the client
process and the warm-in traffic."""


def read(run):
    return run.setup_s
