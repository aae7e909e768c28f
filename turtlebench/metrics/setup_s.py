"""setup_s: from the process's start to the window's first batch: imports,
the program's libraries, the covers, the walk and the warm-up on the
cell's own shapes (host clock)."""


def read(run):
    w = run.window
    if w is None:
        return None
    return w["setup_s"]
