#!/usr/bin/env python3
"""Why two ranks' DreamerV3-S step is not bitwise one process's on the card.

Run from the root of a checkout, on a machine with one CUDA device:

    python3 chip_multihost_determinism.py

``chip_smoke.py``'s ``multihost`` group holds the two-rank gradient step
(two processes on the one card, gloo) to the one-process two-shard step on
the same blocks and noise.  This script shows what decides whether they
agree bit for bit, with the smoke's inputs (``chip_smoke._multihost_step_inputs``):

1. For torch's default kernels and under
   ``torch.use_deterministic_algorithms(True)`` in turn: the one-process
   two-shard step run twice in this process and once in each of two fresh
   processes, and the two-rank step, each's state tensors (the agent's
   parameters and the optimizers' state) compared by digest.
2. Three trials of the two-rank step with every local gradient-norm call
   (``utils.optim.global_norm``, before the shards agree on it) and every
   cross-process collective logged on each rank: whether the ranks'
   collectives, local norms and states after each step match.

Each line names the card and its power limit.  It exits non-zero without a
CUDA device, and in a directory that holds nothing else of the repo.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# one process's two-shard step, as chip_smoke.multihost_step_reference runs
# it, in a fresh interpreter
_REFERENCE = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
if sys.argv[4] == "1":
    torch.use_deterministic_algorithms(True, warn_only=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from sheeprl_tpu_torch.config import compose
out = chip_smoke.multihost_step_reference(compose(json.loads(sys.argv[3])), "cuda")
json.dump(out, open(sys.argv[2], "w"))
"""
# a rank of the two-rank step, its local norms and collectives logged
_RANK = r"""
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import torch
if sys.argv[5] == "1":
    torch.use_deterministic_algorithms(True, warn_only=True)
from torch.utils import _pytree as pytree
import chip_smoke
from sheeprl_tpu_torch.parallel import dp
from sheeprl_tpu_torch.utils import optim

def digest(tree):
    return [hashlib.sha256(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()).hexdigest()[:16]
            for t in pytree.tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]

log = []
across, norm = dp._across_processes, optim.global_norm

def logged_across(op, trees, processes):
    out = across(op, trees, processes)
    log.append({"op": op, "out": digest(out)})
    return out

def logged_norm(tensors):
    out = norm(tensors)
    log.append({"op": "local_norm", "out": digest([out]), "value": float(out)})
    return out

dp._across_processes, optim.global_norm = logged_across, logged_norm
chip_smoke.multihost_step_rank(sys.argv[2], "cuda", json.loads(sys.argv[3]))
record = json.load(open(sys.argv[2]))
record["log"] = log
json.dump(record, open(sys.argv[2], "w"))
"""


def _differ(a, b) -> int:
    return sum(x != y for x, y in zip(a, b))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_multihost_determinism: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "chip_smoke.py").is_file() or not (ROOT / "sheeprl_tpu_torch").is_dir():
        print("chip_multihost_determinism: run from a checkout of the repo", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.ops import cuda_build
    from sheeprl_tpu_torch.resilience.supervisor import child_env

    work = ROOT / "build" / "chip_smoke" / "determinism"
    work.mkdir(parents=True, exist_ok=True)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # cuBLAS's condition for deterministic algorithms
    card = smoke._card_line()
    print(f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi name,power.limit: {card}", flush=True)
    cuda_build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    overrides = smoke._multihost_step_overrides("cuda")
    cfg = compose(overrides)
    env = child_env()

    def ranks(tag: str, deterministic: str) -> list:
        port = smoke._free_port()
        procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(ROOT), str(work / f"{tag}_rank{r}.json"),
                                   json.dumps(overrides), "cuda", deterministic],
                                  env={**env, **smoke._torchrun_env(port, r)}) for r in range(2)]
        if any(p.wait() for p in procs):
            raise AssertionError(f"{tag}: a rank failed")
        return sorted((json.loads((work / f"{tag}_rank{r}.json").read_text()) for r in range(2)),
                      key=lambda s: s["shard"])

    for deterministic in ("0", "1"):
        if deterministic == "1":
            torch.use_deterministic_algorithms(True, warn_only=True)
        here = [smoke.multihost_step_reference(cfg, "cuda") for _ in range(2)]
        fresh_procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, str(ROOT),
                                         str(work / f"ref{deterministic}_{i}.json"), json.dumps(overrides),
                                         deterministic], env=env) for i in range(2)]
        if any(p.wait() for p in fresh_procs):
            raise AssertionError("a fresh reference process failed")
        fresh = [json.loads((work / f"ref{deterministic}_{i}.json").read_text()) for i in range(2)]
        two = ranks(f"reproduce{deterministic}", deterministic)
        one = here[0]["digests"][0]
        out = {"tensors": len(one), "this_process_twice": _differ(one, here[1]["digests"][0]),
               "fresh_processes": _differ(fresh[0]["digests"][0], fresh[1]["digests"][0]),
               "this_vs_fresh": [_differ(one, f["digests"][0]) for f in fresh],
               "ranks": _differ(two[0]["digests"], two[1]["digests"]),
               "rank_vs_one_process": [_differ(two[0]["digests"], one),
                                       _differ(two[0]["digests"], fresh[0]["digests"][0])]}
        mode = "deterministic algorithms" if deterministic == "1" else "default kernels"
        print(f"[reproduce] {mode}: state tensors that differ {json.dumps(out)}  [{card}]", flush=True)
    torch.use_deterministic_algorithms(False)
    for trial in range(3):
        a, b = ranks(f"norms{trial}", "0")
        norms = [(x["value"], y["value"], x["out"] == y["out"]) for x, y in zip(a["log"], b["log"])
                 if x["op"] == "local_norm"]
        collectives = [x["out"] == y["out"] for x, y in zip(a["log"], b["log"]) if x["op"] != "local_norm"]
        print(f"[norms] trial {trial}, default kernels: {len(collectives)} collectives, results equal across "
              f"the ranks {all(collectives)}; local gradient norms (rank 0, rank 1, bitwise equal) "
              f"{json.dumps(norms)}; state tensors that differ between the ranks "
              f"{_differ(a['digests'], b['digests'])} of {len(a['digests'])}  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
