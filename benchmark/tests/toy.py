"""A toy checkout for the CPU tests: the benchmark's own metrics and
traffic, plus a toy configuration (image 32, width 24, depth 2 a stage,
window 4), its cells (one on two ranks) and limits. The limits are the
toy's own (its bf16 rounding is not the full model's), set between the
toy's sound readings and its fp8 control's."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import counts

REPO = Path(__file__).resolve().parents[2]
TOY_MODEL = dict(image_size=32, embed_dim=24, depths=[2, 2, 2, 2], window_size=4)
TOY_TRAIN_LIMITS = {"first_grad_gap": 0.6, "change_gap": 0.2, "change_median_gap": 0.005}
TOY_ROLLOUT_LIMITS = {"state_gap": 0.05}
# name: (traffic file it is cut from, limits, chips, the cell whose metrics it reports)
CELLS = {"toy.train": ("train_b256", TOY_TRAIN_LIMITS, 1, "scot_b.train.b256"),
         "toy.rollout": ("rollout_b256", TOY_ROLLOUT_LIMITS, 1, "scot_b.rollout.b256"),
         "toy.train_ddp": ("train_ddp_b256", TOY_TRAIN_LIMITS, 2, "scot_b.train.b256")}


def make(root: Path) -> Path:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    here = root / "benchmark"
    for d in ("metrics", "traffic", "limits", "configs"):
        shutil.copytree(REPO / "benchmark" / d, here / d)
    cfg = json.loads((REPO / "benchmark/configs/scot_b.json").read_text())
    cfg["name"] = "toy"
    cfg["model"].update(TOY_MODEL)
    cfg["flops"] = {"train_step": counts.affine_count(cfg["model"], True),
                    "forward": counts.affine_count(cfg["model"], False)}
    (here / "configs/toy.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "toy", "source": "toy", "file": "benchmark/configs/toy.json",
                             "reduced": [], "why": "toy"})
    for name, (traffic, limits, chips, real) in CELLS.items():
        t = json.loads((REPO / f"benchmark/traffic/{traffic}.json").read_text())
        t.update(batch=4, reference_rows=2)
        (here / f"traffic/{name}.json").write_text(json.dumps(t))
        (here / f"limits/{name}.json").write_text(json.dumps(limits))
        bench["workloads"].append({"name": name, "config": "toy", "traffic": name,
                                   "chips": chips, "why": "toy"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
