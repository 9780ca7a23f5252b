"""Mean ms of the host copy of the corpus's row-to-video table a
nearest-row query makes: the program's ``corpus.vid_copy`` span."""

from perfbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "corpus.vid_copy")
