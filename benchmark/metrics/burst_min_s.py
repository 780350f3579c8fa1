"""The fastest burst of the window: a burst's pace while the host runs at
its quickest. The host's speed varies from run to run and moves
``burst_s``, its tail and even its 10th percentile by several per cent;
the fastest burst moves about one, so a gain of a few per cent in the
work shows here."""


def read(view):
    return min(view.latencies) if view.latencies else None
