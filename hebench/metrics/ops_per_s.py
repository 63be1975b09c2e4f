"""Operations (ciphertext pairs multiplied, relinearized and rescaled)
completed in the window, over the window's whole time (host clock, the
window ending in a device synchronize)."""


def read(run):
    return run.units / run.window_s
