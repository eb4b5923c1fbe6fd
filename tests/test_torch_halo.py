"""The halo exchanges of the port's multi-device path (parallel/mesh.py
halo_gather / halo_add_deltas, the plain versions of csrc/halo.cu) against
the jax reference's ppermute halos inside shard_map, on the 8 virtual CPU
devices of conftest.py, at n = 2, 4, 8 lanes and h = 1, 4, 8 (tolerance 0):
  - the ring (vtm_tpu/parallel/mesh.py:halo_exchange, rows);
  - the width halo with the picture's borders edge-replicated
    (vtm_tpu/parallel/pic_shard.py:_halo_cols), then edge-padded across as
    the sharded chain pads it for SAO (1 row) and ALF (4 rows);
  - the deblocking's delta return, against the reference's steps at
    vtm_tpu/parallel/pic_shard.py:89-95 written out here, which only
    make_sharded_luma_filters reaches: this checks the plain version's
    layout at every h.  What pins the return to the reference's own code is
    test_torch_parallel.py:test_sharded_deblocking_matches_jax (the
    sharded chain with deblocking alone against make_sharded_luma_filters).
The same seeded numpy inputs go to both sides.
"""

import numpy as np
import pytest
import torch

from vtm_tpu_torch.parallel import mesh as M
from vtm_tpu_torch.parallel import pic_shard as PS

ROWS, COLS = 12, 24  # a lane's shard
# the sharded chain's halo widths and the edge rows it pads them with
HALOS = [(1, 1), (4, 4), (8, 0)]


def jax_mesh(n):
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices conftest.py sets up")
    from vtm_tpu.parallel import mesh as RM

    return jax, RM.codec_mesh(n, gop=1)


def run_sharded(jax, mesh, fn, spec, *arrays):
    """fn over the 'tile' shards of `arrays` (each split by `spec`), as one
    jitted shard_map; the shards' results concatenated by `spec`."""
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding

    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * len(arrays), out_specs=spec))
    put = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec)) for a in arrays]
    return np.asarray(f(*put))


def seeded(n, shape, seed):
    return np.random.default_rng(seed).integers(-1000, 1000, size=shape).astype(np.int32)


@pytest.mark.parametrize("h", [1, 4, 8])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_halo_exchange_ring_matches_jax(n, h):
    jax, mesh = jax_mesh(n)
    from jax.sharding import PartitionSpec as P

    from vtm_tpu.parallel import mesh as RM

    x = seeded(n, (n * ROWS, COLS), 10 * n + h)
    want = run_sharded(jax, mesh, lambda t: RM.halo_exchange(t, h, "tile"),
                       P("tile", None), x)
    got = M.halo_exchange(list(torch.from_numpy(x).split(ROWS)), h)
    assert all(g.shape == (ROWS + 2 * h, COLS) for g in got)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("h,pad", HALOS)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_halo_cols_matches_jax(n, h, pad):
    jax, mesh = jax_mesh(n)
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from vtm_tpu.parallel import pic_shard as RP

    def ext(t):
        e = RP._halo_cols(t, h, n)
        return jnp.pad(e, ((pad, pad), (0, 0)), mode="edge")

    x = seeded(n, (ROWS, n * COLS), 20 * n + h)
    want = run_sharded(jax, mesh, ext, P(None, "tile"), x)
    got = PS._halo_cols(list(torch.from_numpy(x).split(COLS, dim=1)), h, pad=pad)
    assert all(g.shape == (ROWS + 2 * pad, COLS + 2 * h) for g in got)
    np.testing.assert_array_equal(torch.cat(got, dim=1).numpy(), want)


@pytest.mark.parametrize("h", [1, 4, 8])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_add_halo_deltas_matches_jax(n, h):
    """The plain delta return's layout against the reference's ppermute
    steps, copied from pic_shard.py:89-95 with h for its 8 (the reference's
    code runs only inside make_sharded_luma_filters, which
    test_torch_parallel.py:test_sharded_deblocking_matches_jax holds the
    port's chain to)."""
    jax, mesh = jax_mesh(n)
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from vtm_tpu.parallel import pic_shard as RP

    fwd, bwd = RP._perms(n)

    def step(x, acc):
        # vtm_tpu/parallel/pic_shard.py:89-95 on one lane's shard and deltas
        i = jax.lax.axis_index("tile")
        from_left = jax.lax.ppermute(acc[..., -h:], "tile", fwd)
        from_right = jax.lax.ppermute(acc[..., :h], "tile", bwd)
        from_left = jnp.where(i == 0, 0, from_left)
        from_right = jnp.where(i == n - 1, 0, from_right)
        x = x + acc[..., h:-h]
        x = x.at[..., :h].add(from_left)
        return x.at[..., -h:].add(from_right)

    x = seeded(n, (ROWS, n * COLS), 30 * n + h)
    d = seeded(n, (ROWS, n * (COLS + 2 * h)), 40 * n + h) // 8
    want = run_sharded(jax, mesh, step, P(None, "tile"), x, d)
    got = PS.add_halo_deltas(list(torch.from_numpy(x).split(COLS, dim=1)),
                             list(torch.from_numpy(d).split(COLS + 2 * h, dim=1)), h)
    np.testing.assert_array_equal(torch.cat(got, dim=1).numpy(), want)


def test_halo_wrappers_take_the_plain_versions_on_cpu(monkeypatch):
    """CPU shards go to the plain versions, with no kernel launch."""
    from vtm_tpu_torch import kernels as KN

    def refuse(*args):
        raise AssertionError("a CPU tensor reached a kernel launch")

    monkeypatch.setattr(KN, "launch", refuse)
    xs = list(torch.from_numpy(seeded(2, (ROWS, 2 * COLS), 1)).split(COLS, dim=1))
    ext = M.halo_gather(xs, 4, axis=1, pad=4)
    assert [tuple(e.shape) for e in ext] == [(ROWS + 8, COLS + 8)] * 2
    d = [torch.zeros(ROWS, COLS + 8, dtype=torch.int32)] * 2
    assert all(torch.equal(a, b) for a, b in zip(M.halo_add_deltas(xs, d, 4), xs))
