"""HDF5 demo-file tools (reference: scripts/merge_hdf5_files.py,
extract_single_demo_from_hdf5.py). Operates on the Isaac Lab Mimic HDF5
layout: a root "data" group with one "demo_N" subgroup per demo.

Port of ``nvblox_mindmap_tpu/scripts/hdf5_tools.py``. ``h5py`` is imported
when a tool runs; without it the tool raises, naming it::

    python -m nvblox_mindmap_torch.scripts.hdf5_tools list demos.hdf5
    python -m nvblox_mindmap_torch.scripts.hdf5_tools extract demos.hdf5 demo_3 one.hdf5
    python -m nvblox_mindmap_torch.scripts.hdf5_tools merge a.hdf5 b.hdf5 --output all.hdf5
"""
from __future__ import annotations

import argparse
from typing import List


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("the HDF5 demo tools need the h5py module, which is not "
                          "installed") from e
    return h5py


def list_demos(path: str) -> List[str]:
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        return sorted(f["data"].keys(), key=lambda n: int(n.split("_")[-1]))


def extract_single_demo(input_path: str, demo_name: str, output_path: str):
    """Copy one demo group (+ root attrs) to a new file as demo_0."""
    h5py = _h5py()
    with h5py.File(input_path, "r") as src, h5py.File(output_path, "w") as dst:
        data = dst.create_group("data")
        for k, v in src["data"].attrs.items():
            data.attrs[k] = v
        src.copy(f"data/{demo_name}", data, name="demo_0")


def merge_hdf5_files(input_paths: List[str], output_path: str):
    """Concatenate all demos from the inputs, renumbering sequentially."""
    h5py = _h5py()
    with h5py.File(output_path, "w") as dst:
        data = dst.create_group("data")
        idx = 0
        for input_path in input_paths:
            with h5py.File(input_path, "r") as src:
                if idx == 0:
                    for k, v in src["data"].attrs.items():
                        data.attrs[k] = v
                for name in sorted(
                    src["data"].keys(), key=lambda n: int(n.split("_")[-1])
                ):
                    src.copy(f"data/{name}", data, name=f"demo_{idx}")
                    idx += 1
        print(f"Merged {idx} demos into {output_path}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_list = sub.add_parser("list")
    p_list.add_argument("input")
    p_extract = sub.add_parser("extract")
    p_extract.add_argument("input")
    p_extract.add_argument("demo_name")
    p_extract.add_argument("output")
    p_merge = sub.add_parser("merge")
    p_merge.add_argument("inputs", nargs="+")
    p_merge.add_argument("--output", required=True)
    args = parser.parse_args(argv)
    if args.cmd == "list":
        print("\n".join(list_demos(args.input)))
    elif args.cmd == "extract":
        extract_single_demo(args.input, args.demo_name, args.output)
    else:
        merge_hdf5_files(args.inputs, args.output)


if __name__ == "__main__":
    main()
