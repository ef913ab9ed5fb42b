"""Share of the card's float32 peak that the window's training steps used:
the operations of one step of the plain reference at the cell's shapes
(``torch.utils.flop_counter``: convolutions and matrix products, forward
and backward), times the window's steps, over the window's seconds times
the peak."""


def read(ctx):
    L = ctx.layer
    if L.get("entry") != "train" or L.get("peaks") is None or not L.get("flops_per_step"):
        return None
    return 100.0 * L["flops_per_step"] * L["steps"] / (L["window_s"] * L["peaks"]["flops"])
