"""Model FLOPs of the window's pairs (two item forwards) over the window, in percent of 989 TFLOP/s a card used."""

from benchmark.lib.readers import mfu


def read(run):
    return mfu(run, 'score')
