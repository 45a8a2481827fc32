"""Dataset format converter (port of ``sxmc_tpu/io/convert.py``).

    python -m sxmc_tpu_torch.io.convert input.npz output.sxnt
    python -m sxmc_tpu_torch.io.convert a.npz b.npz merged.hdf5

Reads any supported ntuple format (.npz/.npy/.csv/.hdf5/.sxnt, .root
via uproot), concatenates several inputs with a field-layout check
(ttree_io.cpp:124-126), and writes any supported output format.
"""

from __future__ import annotations

import sys

from sxmc_tpu_torch.io.loaders import read_float_tables, write_float_table


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2 or "-h" in argv or "--help" in argv:
        print(__doc__.strip())
        return 0 if ("-h" in argv or "--help" in argv) else 2
    *inputs, output = argv
    data, fields = read_float_tables(inputs)
    write_float_table(output, data, fields)
    print(f"convert: {len(inputs)} file(s), {data.shape[0]} rows, "
          f"fields {fields} -> {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
