"""Share of the card's float32 peak that the window's served events used:
the operations of one event's reconstruction by the plain reference (every
window's generator forward), times the window's events, over the window's
seconds times the peak."""


def read(ctx):
    L = ctx.layer
    if L.get("entry") != "serve" or L.get("peaks") is None or not L.get("flops_per_event"):
        return None
    return 100.0 * L["flops_per_event"] * L["events"] / (L["window_s"] * L["peaks"]["flops"])
