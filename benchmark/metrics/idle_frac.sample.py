"""1 - device busy / the traced window, in %: the traced batch's share of
time in which no kernel or copy ran on the card."""


def read(run):
    t = run.trace
    if t is None or run.values.get('kind') != 'sample':
        return None
    return 100.0 * (1.0 - t.busy_ns() / t.window_ns())
