"""The share of the plain reference's top 10 that the program returned,
over every query answered in the window (the hybrid cells: overlap with the
reference's fused top 10)."""


def read(run):
    return run.recall
