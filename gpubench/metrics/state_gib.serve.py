"""The recurrent state one chunk's cache holds (the Mamba-2 layers' fp32
states and conv windows), in GiB: the program's count of the largest
chunk's cache by kind (``ServeReport.cache_bytes``), the most over the
window's calls. A program that does not count it gives nothing to read."""


def read(ctx):
    if ctx.driver.kind != "serve" or not ctx.calls:
        return None
    counts = [getattr(c.report, "cache_bytes", None) for c in ctx.calls]
    if not all(counts):
        return None
    return max(n.get("ssm_state", 0) + n.get("conv", 0)
               for n in counts) / 2 ** 30
