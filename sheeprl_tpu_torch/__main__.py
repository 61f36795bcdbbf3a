"""``python -m sheeprl_tpu_torch run exp=... | eval checkpoint_path=... | serve checkpoint_path=...``."""

import sys

USAGE = (
    "usage: python -m sheeprl_tpu_torch run exp=dreamer_v3|ppo env=dummy [dotted.key=value ...]\n"
    "       python -m sheeprl_tpu_torch run exp=dreamer_v3|ppo env=dummy "
    "checkpoint.resume_from=<run dir or checkpoint> [dotted.key=value ...]\n"
    "       python -m sheeprl_tpu_torch eval checkpoint_path=<run>/checkpoint/ckpt_<step>_<rank>.ckpt "
    "[dotted.key=value ...]\n"
    "       python -m sheeprl_tpu_torch serve checkpoint_path=<run>/checkpoint/ckpt_<step>_<rank>.ckpt "
    "[dotted.key=value ...]"
)

if __name__ == "__main__":
    # imported here, not at the top: the env workers that the executors
    # spawn import this module again, and need no torch
    from sheeprl_tpu_torch.cli import evaluation, run, serve

    commands = {"run": run, "eval": evaluation, "serve": serve}
    if len(sys.argv) < 2 or sys.argv[1] not in commands:
        sys.exit(USAGE)
    result = commands[sys.argv[1]](sys.argv[2:])
    if sys.argv[1] == "eval":
        print(f"Test/cumulative_reward: {result}")
