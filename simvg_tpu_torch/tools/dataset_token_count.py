"""Token lengths of a split's expressions (counterpart of
``tools/misc/dataset_token_count.py``): mean and percentiles, and the
histogram in buckets of 5, for choosing ``max_token``.

    python -m simvg_tpu_torch.tools.dataset_token_count ANNSFILE
        [--split train] [--tokenizer beit3] [--spm-path P]

Each length counts the expression's tokens plus BOS/EOS, as JAX's does.
``main(argv)`` returns ``{"lengths": [...], "histogram": {start: n}}``.
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from typing import Dict

import numpy as np

from simvg_tpu_torch.data.tokenization import build_tokenizer, clean_string


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description="expression token lengths")
    p.add_argument("annsfile")
    p.add_argument("--split", default="train")
    p.add_argument("--tokenizer", default="beit3")
    p.add_argument("--spm-path", default=None)
    args = p.parse_args(argv)

    tok = build_tokenizer(args.tokenizer, spm_path=args.spm_path)
    with open(args.annsfile) as f:
        anns = json.load(f)[args.split]
    lengths = np.asarray([len(tok.tokenize_to_ids(clean_string(expr))) + 2
                          for ann in anns for expr in ann["expressions"]])
    print(f"expressions: {len(lengths)}")
    print(f"mean {lengths.mean():.1f}  p50 {np.percentile(lengths, 50):.0f}"
          f"  p95 {np.percentile(lengths, 95):.0f}"
          f"  p99 {np.percentile(lengths, 99):.0f}"
          f"  max {lengths.max()}")
    hist = Counter((lengths // 5 * 5).tolist())
    for k in sorted(hist):
        print(f"  len {k:3d}-{k + 4:3d}: {hist[k]}")
    return {"lengths": lengths.tolist(), "histogram": dict(sorted(
        hist.items()))}


if __name__ == "__main__":
    main()
