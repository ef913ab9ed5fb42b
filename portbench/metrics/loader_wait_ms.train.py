"""Mean milliseconds the training loop waited for each batch of the window
(the host clock around the trainer's prefetch generator)."""


def read(ctx):
    waits = ctx.layer.get("loader_wait_s")
    if ctx.layer.get("entry") != "train" or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
