"""The suite's tolerances, in one place: where one result of the suite (exp1's
report, exp3's metrics, the inspection statistics, or a dict of them) differs
from another beyond them. The card is held to the CPU with it, and the port
to ``experiments/``."""

from __future__ import annotations

SSIM_KEYS = ("SSIM", "DTSSIM_L1", "DTSSIM_L2")


def suite_mismatches(got, want, path: str = "") -> list:
    """Each place where ``got`` differs from ``want``: keys and their order,
    counts (so POD/FAR/CSI/HSS), PSS and the statistics' n, min and max
    exactly; SSIM, DTSSIM rtol 1e-5 + atol 1e-7; mean and std (float32)
    rtol 1e-5; every other float rtol 1e-12. NaN equals NaN."""
    if isinstance(want, dict):
        if list(got) != list(want):
            return [f"{path}: keys {list(got)} != {list(want)}"]
        return [m for key in want for m in suite_mismatches(got[key], want[key],
                                                            f"{path}/{key}")]
    if got == want or (got != got and want != want):
        return []
    key = path.rsplit("/", 1)[-1]
    if "/CAT_" in path or key in ("PSS", "n", "min", "max"):
        return [f"{path}: {got!r} != {want!r} (exact)"]
    rtol, atol = ((1e-5, 1e-7) if key in SSIM_KEYS
                  else (1e-5, 0.0) if key in ("mean", "std") else (1e-12, 0.0))
    return [] if abs(got - want) <= atol + rtol * abs(want) else [
        f"{path}: {got!r} != {want!r} (rtol {rtol:g}, atol {atol:g})"]
