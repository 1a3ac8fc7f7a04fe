"""The share of a round in which no operation ran on the device, in %: one
minus the device's busy time per profiled round (the union of the device
operations' intervals over a whole number of K-periods, divided by their
rounds) over the unprofiled window's seconds per round. The profiler's
own host cost stretches the profiled rounds, so their host time is not
the denominator."""


def read(ctx):
    busy = ctx["trace"].busy_s / len(ctx["trace_flags"])
    return 100.0 * (1.0 - busy / (ctx["window_s"] / len(ctx["round_times"])))
