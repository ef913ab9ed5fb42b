"""Mean milliseconds an event of the window spent in the output store's
write (dataset creation, compression and the chunk write), host clock."""


def read(ctx):
    writes = ctx.layer.get("write_s")
    if ctx.layer.get("entry") != "serve" or not writes:
        return None
    return 1e3 * sum(writes) / len(writes)
