"""The card memory the process held at most over the window
(``torch.cuda.max_memory_reserved`` from the window's start), in GiB."""


def read(ctx):
    if ctx.peak_reserved is None:
        return None
    return ctx.peak_reserved / 2 ** 30
