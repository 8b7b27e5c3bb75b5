"""On-device inference example (port of ``examples/serve_on_device.py``).

Batched requests against a reduced LLM with int8-quantized weights and a
KV cache: prefill + token-by-token decode (K10 for every layer of every
decoded token on the card), the inference path the paper serves from the
shared Feature Store foundation.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_on_device \
          [--device cpu]

The reference's weights and prompt (``kernels.prf`` draws), so it prints
the reference example's sample line.
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.launch import serve

ARGV = ["--arch", "qwen2-1.5b", "--reduced", "--int8",
        "--batch", "4", "--prompt-len", "32", "--decode-tokens", "16"]


def main(argv=None, *, session: Optional[dict] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    extra = [] if args.device is None else ["--device", args.device]
    return serve.main(ARGV + extra, session=session)


if __name__ == "__main__":
    raise SystemExit(main())
