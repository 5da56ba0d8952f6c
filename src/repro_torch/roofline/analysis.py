"""Three-term roofline, for an NVIDIA H100 SXM by default.

  compute    = flops_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / LINK_BW

Every quantity is per participant, so the "/ chips" of a total-quantity
formulation is already folded in. The dominant term is the bottleneck.

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) per train-step token
count; for decode steps the per-token model flops is 2*N_active. The ratio
MODEL_FLOPS / counted FLOPs measures how much of the counted compute is
"useful".

The `Hardware` records hold published peaks from NVIDIA's H100 SXM data
sheet (dense rates, no sparsity, at the full 700 W power limit), not
measurements: a card set to a lower power limit runs slower under load.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import SHAPES, get_config


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm"
    peak_flops: float = 989e12      # data sheet: dense bf16 FLOP/s per card
    hbm_bw: float = 3.35e12         # data sheet: HBM3 B/s per card
    link_bw: float = 450e9          # data sheet: NVLink B/s per direction


#: H100 SXM, dense bf16 tensor-core peak (data sheet).
H100 = Hardware("h100-sxm", 989e12, 3.35e12, 450e9)

#: H100 SXM for int32 work outside the tensor cores: the data sheet's
#: 67 TFLOP/s float32 counts 128 lanes per SM and two operations per fused
#: multiply-add; int32 has 64 lanes per SM and one operation per
#: instruction, a quarter of it (67 / 4 = 16.75 TOP/s). Memory and link
#: rates as `H100`.
H100_INT32 = Hardware("h100-sxm-int32", 16.75e12, 3.35e12, 450e9)

HW = H100


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float, hw: Hardware = HW):
    terms = {
        "compute_s": flops_per_device / hw.peak_flops,
        "memory_s": bytes_per_device / hw.hbm_bw,
        "collective_s": collective_bytes_per_device / hw.link_bw,
    }
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    # Perfect-overlap execution time = max(terms); roofline fraction of
    # the dominant resource = its share assuming full overlap.
    return {
        **terms,
        "dominant": dominant.removesuffix("_s"),
        "step_time_overlap_s": bound,
        "step_time_serial_s": total,
        "overlap_efficiency": bound / total if total else 0.0,
    }


def model_flops(arch: str, shape_name: str) -> float:
    """Useful model FLOPs per step per device-equivalent (6ND train /
    2ND decode), using active params for MoE."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def analyze_record(record: dict, *, chips: int | None = None,
                   hw: Hardware = HW) -> dict:
    """Roofline analysis of one result record (arch, shape, mesh, per-device
    flops / bytes / collective bytes)."""
    if record.get("skipped") or record.get("status") != "ok":
        return {"cell": f"{record.get('arch')}/{record.get('shape')}/"
                        f"{record.get('mesh')}",
                "status": record.get("skipped") or record.get("status")}
    chips = chips or 1
    for d in (record.get("mesh_shape") or []):
        chips *= d
    flops = record["flops_per_device"]
    byts = record["bytes_accessed_per_device"]
    coll = record["collectives"]["total_bytes"]
    terms = roofline_terms(flops, byts, coll, hw)
    out = {
        "cell": f"{record['arch']}/{record['shape']}/{record['mesh']}",
        "chips": chips,
        "flops_per_device": flops,
        "bytes_per_device": byts,
        "collective_bytes_per_device": coll,
        **terms,
    }
    if record["arch"] != "rapidx-align":
        mf = model_flops(record["arch"], record["shape"])
        out["model_flops_total"] = mf
        total_flops = flops * chips
        out["useful_flops_ratio"] = mf / total_flops if total_flops else 0.0
        # Hardware utilisation if the step ran at the dominant-term time.
        t = terms["step_time_overlap_s"]
        out["mfu_bound"] = (mf / t) / (chips * hw.peak_flops) if t else 0.0
    return out
