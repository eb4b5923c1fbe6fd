"""decode_fps (pictures/s): every picture decoded in the window over the
whole time of the window, on the host's clock."""


def read(run):
    if run.pictures == 0 or run.window_s <= 0:
        return None
    return run.pictures / run.window_s
