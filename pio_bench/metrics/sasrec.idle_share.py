"""``sasrec.idle_share``: the share of the traced window, in percent, in
which no kernel, copy or memset ran on the card."""


def read(run):
    trace = run.traced
    share = None if trace is None else trace.idle_share()
    return None if share is None else 100.0 * share
