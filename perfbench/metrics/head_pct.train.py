"""The share of device time launched inside the program's ``model.head``
and ``model.head.backward`` spans: the final norm, the tied unembedding
over the vocabulary in float32, the CE with z-loss, and their backward."""
from perfbench.lib import spans


def read(run):
    return spans.share(run, ["model.head", "model.head.backward"])
