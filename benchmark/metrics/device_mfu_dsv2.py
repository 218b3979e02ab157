"""Model FLOPs of the window's samples (three times the forward's, counted on the reference) over the window, in percent of 989 TFLOP/s a card used."""

from benchmark.lib.readers import mfu


def read(run):
    return mfu(run, 'pretrain')
