"""One thread each for torch and numpy's BLAS in a port test process.

The xdist workers share the CPU; numpy's OpenBLAS would otherwise start
a thread per core in every worker, and the scene compiler's Chebyshev
fits run through it. ``threadpoolctl`` caps the live process's pool (an
environment variable comes too late once numpy is imported); a machine
without it runs the tests uncapped.
"""


def cap_threads():
    import torch

    torch.set_num_threads(1)
    try:
        import threadpoolctl
    except ImportError:
        return
    threadpoolctl.threadpool_limits(1)
