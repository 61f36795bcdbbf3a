"""``python -m sheeprl_tpu_torch run exp=... | serve checkpoint_path=...``."""

import sys

from sheeprl_tpu_torch.cli import run, serve

USAGE = (
    "usage: python -m sheeprl_tpu_torch run exp=dreamer_v3 env=dummy diagnostics=off [dotted.key=value ...]\n"
    "       python -m sheeprl_tpu_torch serve checkpoint_path=<run>/checkpoint/ckpt_<step>_<rank>.ckpt "
    "[dotted.key=value ...]"
)

if __name__ == "__main__":
    commands = {"run": run, "serve": serve}
    if len(sys.argv) < 2 or sys.argv[1] not in commands:
        sys.exit(USAGE)
    commands[sys.argv[1]](sys.argv[2:])
