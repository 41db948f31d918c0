"""Tokens of every step completed in the window over the window's wall
seconds, the window fenced by a device sync at both ends."""


def read(run):
    return run.steps * run.tokens_per_step / run.wall_s
