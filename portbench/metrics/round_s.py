"""Seconds per global round: the window's time over the whole rounds it
completed, plain and imputation rounds in the ratio the schedule sets."""


def read(ctx):
    return ctx["window_s"] / len(ctx["round_times"])
