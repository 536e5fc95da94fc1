"""The rank mesh: rays over a "tiles" axis, triangles over a "scene" axis.

The JAX package's `parallel/mesh.py` builds a `jax.sharding.Mesh` of
devices. Here one process drives one device, and a mesh is the grid of
process ranks `rank = tile * n_scene + shard` (the JAX package's
`reshape(n_tiles, n_scene)` of its device list) with two process groups per
rank: the **scene group** (this tile, every shard), over which nearest hits
and shadow distances combine, and the **tiles group** (this shard, every
tile), over which the image is assembled and gradients are summed. A group
of one rank is None. Without a process group only the (1, 1) mesh exists.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

TILES = "tiles"
SCENE = "scene"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (n_tiles, n_scene) grid of ranks and this rank's place in it.
    `tile` and `shard` are None on a rank outside the grid (a world larger
    than the mesh), which takes no part in its work."""

    shape: dict  # {TILES: n_tiles, SCENE: n_scene}, as the JAX mesh's
    ranks: tuple  # ranks[tile][shard] = global rank
    tile: int | None
    shard: int | None
    scene_group: object | None  # this tile's shards
    tiles_group: object | None  # this shard's tiles

    def require_member(self) -> None:
        if self.tile is None:
            raise ValueError(f"rank {dist.get_rank()} is outside the "
                             f"{self.shape[TILES]}x{self.shape[SCENE]} mesh")


def _world() -> tuple[int, int]:
    """(world size, this process's rank); (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_tiles: int, n_scene: int = 1) -> Mesh:
    """Mesh of shape (n_tiles, n_scene) over the first n_tiles * n_scene
    ranks. Every rank of the world must call it, in the same order as its
    other group creations: `dist.new_group` is collective over the world."""
    n, rank = _world()
    need = n_tiles * n_scene
    if n_tiles < 1 or n_scene < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({n_tiles}, {n_scene})")
    if n < need:
        raise ValueError(f"need {need} devices, have {n}")
    ranks = tuple(tuple(t * n_scene + s for s in range(n_scene))
                  for t in range(n_tiles))

    def group_of(members):
        """This rank's group among `members` lists; every rank creates every
        group of more than one rank, in the same order."""
        mine = None
        for m in members:
            if len(m) > 1:
                g = dist.new_group(list(m))
                if rank in m:
                    mine = g
        return mine

    scene_group = group_of(ranks)
    tiles_group = group_of([tuple(row[s] for row in ranks) for s in range(n_scene)])
    inside = rank < need
    return Mesh(shape={TILES: n_tiles, SCENE: n_scene}, ranks=ranks,
                tile=rank // n_scene if inside else None,
                shard=rank % n_scene if inside else None,
                scene_group=scene_group, tiles_group=tiles_group)


def default_mesh(n_devices: int | None = None) -> Mesh:
    """Factor n ranks (default: the world) into (tiles, scene): scene gets 2
    when n is even and >= 4, otherwise everything goes to the tiles axis."""
    n = _world()[0] if n_devices is None else n_devices
    n_scene = 2 if (n >= 4 and n % 2 == 0) else 1
    return make_mesh(n // n_scene, n_scene)
