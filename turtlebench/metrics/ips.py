"""ips: images whose secret came back byte for byte after the embed and the
extract, over the window's seconds (host clock, from the first batch's
submission to the last batch's return)."""


def read(run):
    w = run.window
    if w is None or w["seconds"] <= 0:
        return None
    return w["ok"] / w["seconds"]
