"""The paper's analytical energy model (Tables V & VI, Eq. 12), over the
port's op counter (:func:`repro_torch.models.cnn.count_ops`).

Per-op energies are the paper's Design-Compiler numbers (TSMC 65 nm, 1 GHz;
mW at 1 GHz == pJ/op).  They are a property of the paper's MAC units, not
of any GPU: they are kept verbatim as the paper-reproduction artifact, and
the arithmetic runs in the JAX package's order, so the numbers are equal.

Frameworks:
* ``fp32`` — full-precision training
* ``fp8``  — 8-bit floating-point MULs, fp32 accumulation (HFP8 [14])
* ``int8`` — 8-bit integer (FullINT [12])
* ``mls``  — this paper: <2,4>(+sign) 7-bit MUL, integer local accumulation,
  shift-add group-wise scaling, fp32 adder-tree level.
"""
from __future__ import annotations

from repro_torch.models.cnn import CNNConfig, count_ops

__all__ = ["FLOAT_ADD", "FLOAT_MUL", "MAC_ENERGY_PJ", "conv_energy_ratio",
           "efficiency_ratios", "network_energy"]

# Table V (pJ/op at 65 nm, 1 GHz).
MAC_ENERGY_PJ = {
    "fp32": {"mul": 2.311, "acc": 0.512},
    "fp8": {"mul": 0.105, "acc": 0.512},
    "int8": {"mul": 0.155, "acc": 0.065},
    "mls": {"mul": 0.124, "acc": 0.065},
}
FLOAT_MUL = 2.311
FLOAT_ADD = 0.512


def conv_energy_ratio(k: int = 3) -> float:
    """Eq. 12: energy ratio of a KxK conv MAC group, fp32 vs MLS (~11.5).

    Per input-channel group: K*K MULs + K*K local accumulations + one
    adder-tree addition; MLS adds one group-wise scale op (costed like a
    local accumulation, Eq. 8)."""
    n = k * k
    full = FLOAT_MUL * n + FLOAT_ADD * n + FLOAT_ADD * 1
    ours = (
        MAC_ENERGY_PJ["mls"]["mul"] * n
        + MAC_ENERGY_PJ["mls"]["acc"] * (n + 1)  # local acc + group scale
        + FLOAT_ADD * 1  # adder tree stays fp
    )
    return full / ours


def _op_totals(cfg: CNNConfig) -> dict[str, float]:
    ops = count_ops(cfg, batch=1)
    conv_macs = sum(d["c_in"] * d["c_out"] * d["k"] ** 2 * d["h"] * d["w"] * d["n"]
                    for kd, d in ops if kd == "conv")
    conv_tree = sum(d["c_in"] * d["c_out"] * d["h"] * d["w"] * d["n"]
                    for kd, d in ops if kd == "conv")
    fc_macs = sum(d["d_in"] * d["d_out"] * d["rows"] for kd, d in ops if kd == "fc")
    bn_elems = sum(d["numel"] for kd, d in ops if kd == "bn")
    ew_elems = sum(d["numel"] for kd, d in ops if kd == "ew_add")
    act_elems = sum(d["c_out"] * d["h"] * d["w"] * d["n"]
                    for kd, d in ops if kd == "conv")
    w_elems = sum(d["c_in"] * d["c_out"] * d["k"] ** 2 for kd, d in ops if kd == "conv")
    return {
        "conv_macs_fwd": conv_macs,
        "conv_tree_fwd": conv_tree,
        "fc_macs_fwd": fc_macs,
        "bn_elems_fwd": bn_elems,
        "ew_elems_fwd": ew_elems,
        "act_elems": act_elems,
        "w_elems": w_elems,
    }


def network_energy(cfg: CNNConfig, framework: str = "mls") -> dict[str, float]:
    """Per-image training-step energy (uJ), paper Table VI methodology.

    Training = 3 conv passes (fwd + error-bwd + weight-grad, Table I);
    BN fwd 5 ops + bwd 12 ops per element (paper Eq. 13/14: 9 mul + 10 add);
    SGD update: 1 mul + 1 add per weight (+momentum: 2/2 — paper counts a
    plain update, we follow the paper); DQ: 4 mul + 2 add per quantized
    element (W once, A once, E once per step).
    """
    t = _op_totals(cfg)
    e = MAC_ENERGY_PJ[framework]
    train_macs = 3 * t["conv_macs_fwd"]
    train_tree = 3 * t["conv_tree_fwd"]
    rows: dict[str, float] = {}
    if framework == "fp32":
        rows["conv_mul"] = train_macs * FLOAT_MUL
        rows["conv_add"] = train_macs * FLOAT_ADD
    else:
        rows["conv_mul"] = train_macs * e["mul"]
        # local accumulation + group-wise scaling at the acc cost
        rows["conv_acc"] = train_macs * e["acc"]
        if framework == "mls":
            rows["group_scale"] = train_tree * e["acc"]
        # adder-tree level stays floating point (fp8/mls); int8 keeps int
        tree_cost = FLOAT_ADD if framework in ("fp8", "mls") else e["acc"]
        rows["conv_tree"] = train_tree * tree_cost
    # BN: 9 mul + 10 add per element over fwd+bwd (paper Sec. VI-E)
    rows["bn"] = t["bn_elems_fwd"] * (9 * FLOAT_MUL + 10 * FLOAT_ADD) / 2
    # FC fwd+bwd (3 passes), full precision in every framework
    rows["fc"] = 3 * t["fc_macs_fwd"] * (FLOAT_MUL + FLOAT_ADD)
    # SGD update (full precision everywhere)
    rows["sgd"] = t["w_elems"] * (2 * FLOAT_MUL + 2 * FLOAT_ADD)
    # element-wise residual adds (+ scale-merge muls for MLS, Table VI)
    rows["ew_add"] = t["ew_elems_fwd"] * 2 * FLOAT_ADD
    if framework == "mls":
        rows["ew_add"] += t["ew_elems_fwd"] * FLOAT_MUL
        dq_elems = t["w_elems"] + 2 * t["act_elems"]
        rows["dq"] = dq_elems * (4 * FLOAT_MUL + 2 * FLOAT_ADD)
    total_pj = sum(rows.values())
    rows = {k: v * 1e-6 for k, v in rows.items()}  # pJ -> uJ
    rows["total_uj"] = total_pj * 1e-6
    return rows


def efficiency_ratios(cfg: CNNConfig) -> dict[str, float]:
    ours = network_energy(cfg, "mls")["total_uj"]
    return {
        "vs_fp32": network_energy(cfg, "fp32")["total_uj"] / ours,
        "vs_fp8": network_energy(cfg, "fp8")["total_uj"] / ours,
        "vs_int8": network_energy(cfg, "int8")["total_uj"] / ours,
    }
