"""Share of its roofline that the dk MLP tail's forward reached in the
traced steps: the least time for the launches seen (bound by operations:
per (frame, pixel) two (h, h) layers and the last dot, 4 h^2 + 4 h, at the
float32 peak; its bytes, phi, the offsets and the weights in and the
(J, HW) field out, need far less), over the device time of
``dk_mlp_tail_kernel`` (``csrc/dk_mlp_tail.cu``, #12). J = B x T frames and
the cell's pixels, h = 100."""

import re

KERNEL = re.compile(r"\bdk_mlp_tail_kernel\b")
HIDDEN = 100


def read(ctx):
    s, L = ctx.trace_summary, ctx.layer
    if not s or L.get("peaks") is None or L.get("entry") != "train":
        return None
    hits = [v for k, v in s["kernels"].items() if KERNEL.search(k)]
    launches, seconds = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not launches or seconds <= 0:
        return None
    sz = L["sizes"]
    J, hw, h = L["batch"] * sz["T"], sz["H"] * sz["W"], HIDDEN
    ops = J * hw * (4.0 * h * h + 4.0 * h)
    nbytes = 4.0 * (hw * h + J * h + 2 * h * h + 3 * h + 1 + J * hw)
    bound = max(ops / L["peaks"]["flops"], nbytes / L["peaks"]["bytes_per_s"])
    return 100.0 * launches * bound / seconds
