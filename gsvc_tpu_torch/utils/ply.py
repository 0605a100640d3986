"""Binary little-endian PLY writer and reader for model snapshots (port of
gsvc_tpu/utils/ply.py: ``write_ply``, ``read_ply``, ``save_gaussian_ply``,
``load_gaussian_ply``).

A snapshot's ``point_cloud.ply`` holds one float32 vertex a anchor, in the
JAX package's column order: ``x y z nx ny nz f_offset_* f_mask_*
f_anchor_feat_* opacity scale_* rot_*``; the same arrays give the same
file bytes in both packages.  Host-side numpy only.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def write_ply(path: str, props: List[Tuple[str, np.ndarray]]) -> None:
    """props: ordered [(name, [N] float32 column)]."""
    n = props[0][1].shape[0]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    for name, col in props:
        if col.shape != (n,):
            raise ValueError(f"{name}: shape {col.shape}, expected ({n},)")
        header.append(f"property float {name}")
    header.append("end_header")
    data = np.stack([c.astype("<f4") for _, c in props], axis=1)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """{property name: [N] float32 column} of a ``write_ply`` file."""
    with open(path, "rb") as f:
        names = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(4 * n * len(names)), "<f4")
    data = data.reshape(n, len(names))
    return {name: data[:, i].copy() for i, name in enumerate(names)}


def save_gaussian_ply(path: str, anchors_dict: Dict[str, np.ndarray]) -> None:
    """Write the anchors (the AnchorState fields as [N, ...] numpy arrays)
    as one vertex each; offsets and masks go [N, K, c] -> [N, c*K]."""
    a = anchors_dict
    n = a["anchor"].shape[0]
    props: List[Tuple[str, np.ndarray]] = [
        ("x", a["anchor"][:, 0]), ("y", a["anchor"][:, 1]),
        ("z", a["anchor"][:, 2]),
        ("nx", np.zeros(n, np.float32)), ("ny", np.zeros(n, np.float32)),
        ("nz", np.zeros(n, np.float32)),
    ]
    off = a["offset"].transpose(0, 2, 1).reshape(n, -1)  # [N, 3*K]
    props += [(f"f_offset_{i}", off[:, i]) for i in range(off.shape[1])]
    msk = a["mask"].transpose(0, 2, 1).reshape(n, -1)
    props += [(f"f_mask_{i}", msk[:, i]) for i in range(msk.shape[1])]
    props += [(f"f_anchor_feat_{i}", a["feat"][:, i])
              for i in range(a["feat"].shape[1])]
    props.append(("opacity", a["opacity"][:, 0]))
    props += [(f"scale_{i}", a["scaling"][:, i])
              for i in range(a["scaling"].shape[1])]
    props += [(f"rot_{i}", a["rotation"][:, i])
              for i in range(a["rotation"].shape[1])]
    write_ply(path, props)


def load_gaussian_ply(path: str) -> Dict[str, np.ndarray]:
    """The anchors dict ``save_gaussian_ply`` wrote."""
    cols = read_ply(path)
    n = cols["x"].shape[0]

    def group(prefix):
        names = sorted((k for k in cols if k.startswith(prefix)),
                       key=lambda s: int(s.rsplit("_", 1)[1]))
        return np.stack([cols[k] for k in names], axis=1)

    offsets = group("f_offset_")
    masks = group("f_mask_")
    k = masks.shape[1]
    return {
        "anchor": np.stack([cols["x"], cols["y"], cols["z"]], axis=1),
        "offset": offsets.reshape(n, 3, k).transpose(0, 2, 1),
        "mask": masks.reshape(n, 1, k).transpose(0, 2, 1),
        "feat": group("f_anchor_feat_"),
        "opacity": cols["opacity"][:, None],
        "scaling": group("scale_"),
        "rotation": group("rot_"),
    }
