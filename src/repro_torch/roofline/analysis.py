"""Three-term roofline of a model step, per card.

Counterpart of :mod:`repro.roofline.analysis`:

    compute    = FLOPs            / (cards * peak FLOP/s of the compute dtype)
    memory     = bytes            / (cards * HBM rate)
    collective = collective bytes / (cards * link rate)

The reference reads FLOPs, bytes and collective bytes from compiled HLO.
The port has no HLO: :mod:`repro_torch.roofline.cost` counts the step's
products, the bytes of its operators and the result bytes of its
collectives by kind while it runs (on the ``meta`` device for a dry run,
on one card or on a production mesh of a fake process group), so
``collective_bytes_from_hlo`` has no counterpart here.  The collective
term divides a rank's collective bytes by one card's NVLink rate, the
reference's one link rate: a job of 256 cards spans nodes, whose links
between them are slower, so on such a mesh the term is a lower bound
that is looser still.

The peaks are NVIDIA's data-sheet figures of the card, without
sparsity, at its full power limit.  Unlike the reference's single peak,
the compute term takes the peak of the step's compute dtype: bf16 runs
on the tensor cores, float32 on FMA (TF32 stays off in the port).
:func:`bound` is the per-kernel bound that the smoke's ``kernels`` line
uses.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    hbm_bw: float                    # bytes/s of device memory
    bf16_flops: float                # dense bf16 FLOP/s on the tensor cores
    f32_flops: float                 # float32 FLOP/s on FMA
    link_bw: float                   # bytes/s between cards

    def flops_s(self, dtype: torch.dtype) -> float:
        """The peak FLOP/s of products in ``dtype``: bf16 and fp16 on the
        tensor cores, float32 on FMA."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.bf16_flops
        if dtype == torch.float32:
            return self.f32_flops
        raise ValueError(f"no peak for {dtype} on {self.name}")


# NVIDIA H100 SXM5 80GB data sheet: HBM3 3.35 TB/s, bf16 989 TFLOP/s
# dense, float32 67 TFLOP/s; NVLink 900 GB/s a card (18 links, both
# directions together), which no one-card cell uses
H100_SXM = HardwareSpec(name="h100-sxm-80gb", hbm_bw=3.35e12, bf16_flops=989e12,
                        f32_flops=67e12, link_bw=900e9)

# the card names torch.cuda.get_device_name gives, and their specs
CARDS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def spec_for_card(name: str) -> HardwareSpec:
    """The spec of the card ``name`` (as ``torch.cuda.get_device_name``
    gives it); raises for a card without a spec."""
    try:
        return CARDS[name]
    except KeyError:
        raise ValueError(f"no hardware spec for card {name!r}: known {sorted(CARDS)}") from None


def bound(bytes_moved: float, flops: float, peak: float,
          hw: HardwareSpec) -> tuple[float, str]:
    """Least milliseconds of one call: its inputs read once and outputs
    written once at ``hw``'s HBM rate, or its flops at ``peak`` FLOP/s
    (``hw.flops_s`` of the operands' type), the larger, and which of the two
    (``"bytes"`` or ``"operations"``).  A cold call brings its inputs from
    HBM; where a timing loop keeps them in L2 the bound is loose."""
    t_bytes = bytes_moved / hw.hbm_bw * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_report(*, flops: float, bytes_accessed: float, collective_bytes: float,
                    n_chips: int, model_flops: float, hw: HardwareSpec,
                    dtype: torch.dtype) -> dict:
    """Per-step roofline terms in seconds and the dominant term, with the
    reference's keys and arithmetic (``repro/roofline/analysis.py:98``).

    ``flops`` and ``bytes_accessed`` are per card; ``model_flops`` is the
    whole job's (6 N D or 2 N D), so its per-card share is ``model_flops
    / n_chips``.  The compute term runs at the peak of ``dtype``, the
    step's compute dtype (``compute_dtype`` in the result).
    """
    peak = hw.flops_s(dtype)
    compute_s = flops / peak
    memory_s = bytes_accessed / hw.hbm_bw
    collective_s = collective_bytes / hw.link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    step_bound = max(terms.values())
    mf_chip = model_flops / n_chips
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "step_time_lower_bound_s": step_bound,
        "model_flops": model_flops,
        "hlo_flops_per_chip": flops,
        "useful_flops_ratio": (mf_chip / flops) if flops else 0.0,
        "mfu_upper_bound": (mf_chip / peak / step_bound) if step_bound else 0.0,
        "n_chips": n_chips,
        "hw": hw.name,
        "compute_dtype": str(dtype).removeprefix("torch."),
    }
