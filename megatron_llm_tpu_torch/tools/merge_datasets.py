"""Merge every .bin/.idx dataset of a directory into one (port of
tools/merge_datasets.py; ref: tools/merge_datasets.py).

    python -m megatron_llm_tpu_torch.tools.merge_datasets \\
        --input dir_of_datasets --output_prefix merged

The datasets are merged in the sorted order of their prefixes, with the
first one's token dtype, through the port's own
`data/indexed_dataset.py`; the output is byte-identical to the JAX
package's tool's for the same input.
"""

from __future__ import annotations

import argparse
import os

from megatron_llm_tpu_torch.data.indexed_dataset import (
    MMapIndexedDataset,
    MMapIndexedDatasetBuilder,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", type=str, required=True,
                   help="directory containing .bin/.idx pairs to merge")
    p.add_argument("--output_prefix", type=str, required=True)
    args = p.parse_args(argv)

    prefixes = sorted({
        os.path.join(args.input, f[:-4]) for f in os.listdir(args.input)
        if f.endswith(".bin") or f.endswith(".idx")})
    prefixes = [p_ for p_ in prefixes if MMapIndexedDataset.exists(p_)]
    if not prefixes:
        raise SystemExit(f"no .bin/.idx pairs under {args.input}")

    first = MMapIndexedDataset(prefixes[0])
    dtype = first.dtype
    first.close()

    builder = MMapIndexedDatasetBuilder(args.output_prefix + ".bin",
                                        dtype=dtype)
    for prefix in prefixes:
        print(f"merging {prefix}")
        builder.merge_file_(prefix)
    builder.finalize(args.output_prefix + ".idx")
    print(f"done -> {args.output_prefix}.bin/.idx")


if __name__ == "__main__":
    main()
