"""Perf-iteration harness, the port of the reference's
``repro/launch/perf.py``.

Each named VARIANT re-runs one (arch × shape) cell's dry run
(:mod:`repro_torch.launch.dryrun`) with a ``TrainConfig`` knob or a
sharding-rule change, records the roofline terms on the H100's constants
and prints them: one hypothesis→change→measure cycle per invocation. The
reference runs its variants with ``unroll=True`` so that XLA's cost
analysis counts every layer; the port's layer loop is a Python loop, so
every record already counts every layer and there is no such knob.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch granite-20b \\
        --shape decode_32k --variant dist_decode
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

from repro_torch.configs import get_shape
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.launch.roofline import model_flops
from repro_torch.parallel import sharding as SH
from repro_torch.train.loop import TrainConfig

OUT = "results/perf_torch"


def _rules(base: Dict, **overrides) -> Dict:
    out = dict(base)
    out.update(overrides)
    return out


Variant = Tuple[TrainConfig, Optional[Dict], Optional[Dict]]


# Each variant: name -> (train config, act rules, param rules); ``kind``
# ("train" or "serve") picks the applicable ones.
def variants(kind: str) -> Dict[str, Variant]:
    train = kind == "train"
    base_tc = TrainConfig(remat="full" if train else "none", impl="ref")
    v: Dict[str, Variant] = {
        "baseline": (base_tc, None, None),
    }
    if train:
        v["remat_dots"] = (dataclasses.replace(base_tc, remat="dots"),
                           None, None)
        v["remat_dots_no_batch"] = (
            dataclasses.replace(base_tc, remat="dots_no_batch"), None, None)
        v["remat_none"] = (dataclasses.replace(base_tc, remat="none"),
                           None, None)
        v["ef_int8_grads"] = (
            dataclasses.replace(base_tc, grad_compression=True), None, None)
        v["microbatch4"] = (
            dataclasses.replace(base_tc, microbatches=4), None, None)
        # FSDP off: keep params replicated over data (pure TP)
        v["no_fsdp"] = (base_tc, None, _rules(SH.PARAM_RULES, embed=None))
        # TP off: pure DP+FSDP; the per-layer activation all-reduces go,
        # only the gradient reduction remains
        no_tp_act = _rules(SH.ACT_RULES, heads=None, kv_heads=None,
                           mlp=None, vocab=None, expert=None,
                           batch=("pod", "data", "model"))
        no_tp_param = _rules(SH.PARAM_RULES, heads=None, kv_heads=None,
                             mlp=None, vocab=None, expert=None,
                             mamba_inner=None, mamba_heads=None)
        v["no_tp"] = (base_tc, no_tp_act, no_tp_param)
        # stack the winners: DP-only + gradient accumulation shrinks live
        # activation temporaries; dots-remat trades a little recompute
        v["no_tp_mb4_dots"] = (
            dataclasses.replace(base_tc, remat="dots", microbatches=4),
            no_tp_act, no_tp_param)
        v["no_tp_mb8_full"] = (
            dataclasses.replace(base_tc, microbatches=8),
            no_tp_act, no_tp_param)
        # shard the sequence dim of activations over model (context par.)
        v["seq_shard"] = (base_tc,
                          _rules(SH.ACT_RULES, seq="model", heads=None,
                                 mlp=None, vocab=None),
                          None)
    else:
        v["kv_seq_unsharded"] = (
            base_tc, _rules(SH.ACT_RULES, kv_seq=None), None)
        v["kv_batch_model"] = (
            base_tc, _rules(SH.ACT_RULES, kv_seq=None,
                            batch=("pod", "data", "model")), None)
        # sequence-parallel decode: each rank's partial softmax over its
        # chunk of the seq-sharded cache (kernels/decode_attention/
        # distributed.py)
        v["dist_decode"] = (
            dataclasses.replace(base_tc, impl="dist"), None, None)
    # vocab over data instead of model (the lm-head collective's shape)
    v["vocab_over_data"] = (
        base_tc,
        _rules(SH.ACT_RULES, vocab="data"),
        _rules(SH.PARAM_RULES, vocab="data", embed="model"))
    return v


def terms(rec: Dict) -> Dict[str, float]:
    mf = model_flops(rec["arch"], rec["shape"])
    compute = rec["flops_per_device"] / PEAK_FLOPS_BF16
    mem = rec["memory"]
    memory = (mem["argument_bytes"] + mem["output_bytes"]
              + 2 * mem["temp_bytes"]) / HBM_BW  # buffer-traffic LB
    coll = rec["collectives"]["total_bytes"] / LINK_BW
    step = max(compute, memory, coll)
    return {
        "compute_s": compute, "memory_s": memory, "collective_s": coll,
        "bound": max((("compute", compute), ("memory", memory),
                      ("collective", coll)), key=lambda kv: kv[1])[0],
        "step_s": step,
        "roofline_fraction": (mf / rec["n_devices"] / PEAK_FLOPS_BF16)
        / step,
        "model_over_hlo": mf / (rec["flops_per_device"] * rec["n_devices"]),
    }


def run_variant(arch: str, shape: str, variant: str,
                out_dir: str = OUT, **cell_kw) -> Dict:
    kind = get_shape(shape).kind
    vs = variants("train" if kind == "train" else "serve")
    if variant not in vs:
        raise SystemExit(f"unknown variant {variant!r}; "
                         f"have: {', '.join(vs)}")
    tc, act_rules, param_rules = vs[variant]
    rec = run_cell(arch, shape, False, tc=tc, out_dir=out_dir,
                   act_rules=act_rules, param_rules=param_rules,
                   tag=f"perf-{variant}", **cell_kw)
    rec["terms"] = terms(rec)
    if cell_kw.get("save", True):
        with open(os.path.join(
                out_dir, f"{arch}__{shape}__{variant}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True)
    args = ap.parse_args(argv)
    rec = run_variant(args.arch, args.shape, args.variant)
    t = rec["terms"]
    print(f"{args.arch} × {args.shape} × {args.variant}: "
          f"compute {t['compute_s']*1e3:.2f}ms "
          f"memory {t['memory_s']*1e3:.2f}ms "
          f"collective {t['collective_s']*1e3:.2f}ms "
          f"bound={t['bound']} "
          f"roofline={t['roofline_fraction']:.2%} "
          f"useful/step={t['model_over_hlo']:.2f}")


if __name__ == "__main__":
    main()
