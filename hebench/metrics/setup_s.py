"""Process start to the window's start: imports, loading (or building)
the CUDA library, keygen from the seed, encoding and encryption, and the
warm-up call of the cell's shapes."""


def read(run):
    return run.setup_s
