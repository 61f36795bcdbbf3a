"""``python -m sheeprl_tpu_torch serve checkpoint_path=...`` -> the policy server."""

import sys

from sheeprl_tpu_torch.cli import serve

if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] != "serve":
        sys.exit("usage: python -m sheeprl_tpu_torch serve checkpoint_path=<run>/checkpoint/ckpt_<step>_<rank>.ckpt "
                 "[dotted.key=value ...]  (training is not ported yet: see ROADMAP.md)")
    serve(sys.argv[2:])
