"""Arithmetic the readers share."""

from __future__ import annotations

#: the aggregation's kernels (rows 5 and 5b) and the codec's (rows 1–4)
AGG_KERNELS = ("segment_mean_csr_kernel", "segment_mean_csr_bwd_kernel",
               "segment_mean_csr_bwd_quotient_kernel")
CODEC_KERNELS = ("quantize_quads_kernel", "quantize_rows_kernel",
                 "dequantize_quads_kernel", "scatter_quads_kernel",
                 "dequantize_rows_kernel", "dequantize_add_sorted_kernel")


def region_seconds(rec: dict, *labels: str) -> float:
    return sum(b - a for lab in labels for a, b in rec["regions"].get(lab, ()))


def span_seconds(rec: dict, name: str) -> float:
    return sum(d for n, _, d in rec.get("spans", ()) if n == name)


def span_mean(rec: dict, name: str) -> float | None:
    """Mean seconds of the spans ``name``; None when there is none."""
    d = [d for n, _, d in rec.get("spans", ()) if n == name]
    return sum(d) / len(d) if d else None


def rounds_seconds(rec: dict) -> float:
    return sum(r["t1"] - r["t0"] for r in rec.get("rounds", ()))


def kernel_seconds(rec: dict, names: tuple) -> float:
    return sum(d for n, _, d in rec["trace"]["events"]
               if any(k in n for k in names))


def share(part: float, whole: float) -> float | None:
    """``part`` over ``whole`` in percent; None when either is 0."""
    if part <= 0 or whole <= 0:
        return None
    return part / whole * 100.0


def roofline(rec: dict, nbytes_key: str, names: tuple) -> float | None:
    """Bound time of the recorded calls' bytes at the card's memory rate
    over the device time of their kernels, in percent."""
    nbytes = rec.get(nbytes_key, 0)
    return share(nbytes / rec["config"]["peaks"]["hbm_bytes_per_s"],
                 kernel_seconds(rec, names))


def mfu(rec: dict, seconds: float) -> float | None:
    """The recorded model FLOPs over ``seconds`` at the card's float32
    peak, in percent."""
    return share(rec.get("flops", 0) / rec["config"]["peaks"]["fp32_flops_per_s"],
                 seconds)
