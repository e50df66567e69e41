"""Time both flash attention kernels of one checkout on the card, at the
main path's shapes (head dims 15 and 9, B = 1, 8, 32) and at head dims 64 to
256, by CUDA-graph replay as ``chip_smoke.gpu_time_ms`` does.

Run from the repository root on a machine with a card:

    python3 compare_flash_kernels.py <checkout> <label>

``<checkout>`` is the root of any checkout of this repository (``.`` for
this one). The run builds that checkout's kernels, prints nvcc's register
and spill lines for what it built, then one JSON line per shape: the kernel,
B, L, S, D, masked, its time in ms and its largest difference from the plain
version; a shape whose head dim that checkout's kernels refuse is printed as
skipped. To compare two versions, unpack the other one (``git archive``)
into a directory and run the two in turns on one card: other, this, this,
other.
"""
import json
import os
import sys


def shapes():
    """(B, L, S, D, masked) of every timed call (H = 8)."""
    out = []
    for B in (1, 8, 32):
        for tokens in (4096, 3072, 2048):  # flagship, one-camera app, mesh
            self_tokens = 1 + tokens // 5
            out += [(B, 3, tokens, 15, False), (B, 1, tokens, 15, True),
                    (B, self_tokens, self_tokens, 15, True)]
    out += [(8, 3, 512, 9, False), (8, 129, 129, 9, True),
            (8, 3, 2048, 64, False), (8, 410, 410, 64, True),
            (8, 1, 2048, 128, True), (8, 410, 410, 128, True)]
    for D in (144, 192, 256):
        out += [(8, 3, 2048, D, False), (8, 1, 2048, D, True), (8, 410, 410, D, True)]
    return out


def main(root: str, label: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke
    from nvblox_mindmap_torch.ops import _build
    from nvblox_mindmap_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("compare_flash_kernels: no CUDA device", file=sys.stderr)
        return 1
    for name, log in _build.build_all().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(json.dumps({"label": label, "ptxas": name, "line": line.strip()}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, L, S, D, masked in shapes():
        q = torch.randn(B, 8, L, D, device="cuda", generator=gen) * D**-0.5
        k = torch.randn(B, 8, S, D, device="cuda", generator=gen)
        v = torch.randn(B, 8, S, D, device="cuda", generator=gen)
        mask = torch.rand(B, S, device="cuda", generator=gen) > 0.2 if masked else None
        row = {"label": label, "B": B, "L": L, "S": S, "D": D, "masked": masked}
        try:
            out = fa.flash_attention(q, k, v, mask)
        except ValueError as e:
            print(json.dumps({**row, "skipped": str(e)}))
            continue
        err = (out - fa.flash_attention_reference(q, k, v, mask)).abs().max().item()
        ms = chip_smoke.gpu_time_ms(lambda: fa.flash_attention(q, k, v, mask))
        print(json.dumps({**row, "kernel": fa.kernel_for(L), "ms": ms, "err": err}),
              flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
