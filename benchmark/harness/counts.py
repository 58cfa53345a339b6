"""The program's own counts: kernel launches, counter blocks by path and
by pack rung, baselines and feature builds.  They are module globals of
the program, read here before and after a job (never reset), and go on
the run's earlier lines, not into metrics."""

import sys

FIELDS = {
    "K1": ("distance_tpu_torch.ops.counters", "LAUNCHES"),
    "K2 rel4": ("distance_tpu_torch.ops.packing", "LAUNCHES_REL4"),
    "K2 rel": ("distance_tpu_torch.ops.packing", "LAUNCHES_REL"),
    "K4 narrow": ("distance_tpu_torch.ops.packing", "LAUNCHES_NARROW"),
    "K4 wide": ("distance_tpu_torch.ops.packing", "LAUNCHES_WIDE"),
    "K3": ("distance_tpu_torch.ops.diffup", "LAUNCHES"),
    "K5": ("distance_tpu_torch.ops.cached", "LAUNCHES_FEATURES"),
    "K6": ("distance_tpu_torch.ops.cached", "LAUNCHES_CONTRACT"),
    "K7": ("distance_tpu_torch.ops.basecount", "LAUNCHES"),
    "K8": ("distance_tpu_torch.ops.estimate", "LAUNCHES"),
    "k1_blocks": ("distance_tpu_torch.engine", "K1_BLOCKS"),
    "k6_blocks": ("distance_tpu_torch.engine", "K6_BLOCKS"),
    "baselines": ("distance_tpu_torch.engine", "BASELINES"),
    "rung_blocks": ("distance_tpu_torch.engine", "RUNG_BLOCKS"),
    "feature_builds": ("distance_tpu_torch.engine", "FEATURE_BUILDS"),
}


def read() -> dict:
    out = {}
    for key, (mod, attr) in FIELDS.items():
        v = getattr(sys.modules.get(mod), attr, None)
        if v is not None:
            out[key] = dict(v) if isinstance(v, dict) else v
    return out


def delta(before: dict, after: dict) -> dict:
    out = {}
    for key, v in after.items():
        w = before.get(key, {} if isinstance(v, dict) else 0)
        out[key] = ({k: v[k] - w.get(k, 0) for k in v}
                    if isinstance(v, dict) else v - w)
    return out
