"""The share of the traced window in which no device op ran, in %
(every ``idle_share.<cell>``)."""


def read(view, run):
    return (1.0 - view.busy_s / view.window_s) * 100.0
