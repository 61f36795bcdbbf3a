"""``python -m sheeprl_tpu_torch run exp=... | eval checkpoint_path=... | serve checkpoint_path=...``."""

import sys

from sheeprl_tpu_torch.cli import evaluation, run, serve

USAGE = (
    "usage: python -m sheeprl_tpu_torch run exp=dreamer_v3 env=dummy [dotted.key=value ...]\n"
    "       python -m sheeprl_tpu_torch run exp=dreamer_v3 env=dummy "
    "checkpoint.resume_from=<run dir or checkpoint> [dotted.key=value ...]\n"
    "       python -m sheeprl_tpu_torch eval checkpoint_path=<run>/checkpoint/ckpt_<step>_<rank>.ckpt "
    "[dotted.key=value ...]\n"
    "       python -m sheeprl_tpu_torch serve checkpoint_path=<run>/checkpoint/ckpt_<step>_<rank>.ckpt "
    "[dotted.key=value ...]"
)

if __name__ == "__main__":
    commands = {"run": run, "eval": evaluation, "serve": serve}
    if len(sys.argv) < 2 or sys.argv[1] not in commands:
        sys.exit(USAGE)
    result = commands[sys.argv[1]](sys.argv[2:])
    if sys.argv[1] == "eval":
        print(f"Test/cumulative_reward: {result}")
