"""Share of its roofline that the dk MLP tail's backward reached in the
traced steps: the least time the card needs for the launches seen (bound by
operations: per (frame, pixel) the four (h, h) products of the backward, two
through the transposed weights and two for the weight gradients, and their
elementwise work, 8 h^2 + 10 h, at the float32 peak; a forward recomputed
inside the kernel is the kernel's choice and not counted; its bytes, phi,
the cotangent and the weights in and the gradients out, need far less), over
the device time
of the kernels that implement it: ``dk_mlp_tail_bwd_kernel`` and
``sum_block_partials_kernel`` (``csrc/dk_mlp_tail_bwd.cu``, #13). J = B x T
frames and the cell's pixels, h = 100."""

import re

KERNELS = re.compile(r"\b(dk_mlp_tail_bwd_kernel|sum_block_partials_kernel)\b")
MAIN = re.compile(r"\bdk_mlp_tail_bwd_kernel\b")
HIDDEN = 100


def read(ctx):
    s, L = ctx.trace_summary, ctx.layer
    if not s or L.get("peaks") is None or L.get("entry") != "train":
        return None
    seconds = sum(v[1] for k, v in s["kernels"].items() if KERNELS.search(k))
    launches = sum(v[0] for k, v in s["kernels"].items() if MAIN.search(k))
    if not launches or seconds <= 0:
        return None
    sz = L["sizes"]
    J, hw, h = L["batch"] * sz["T"], sz["H"] * sz["W"], HIDDEN
    ops = J * hw * (8.0 * h * h + 10.0 * h)
    nbytes = 4.0 * (2 * hw * h + 2 * J * h + J * hw + 4 * h * h + 6 * h)
    bound = max(ops / L["peaks"]["flops"], nbytes / L["peaks"]["bytes_per_s"])
    return 100.0 * launches * bound / seconds
