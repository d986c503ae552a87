"""Distributed-join scaling harness (virtual mesh or real devices).

North star (BASELINE.json): >= 80% rows/s scaling efficiency from 1
device to 1 host to >= 2 hosts.  By default (JAX_PLATFORMS unset) this
runs the FULL distributed graph on 1/2/4/8 virtual CPU devices —
validating that the sharded program compiles, executes, and stays exact
at every width; a time on a virtual mesh measures nothing.  With
JAX_PLATFORMS=cuda it runs on the host's GPUs and the throughput column
is a device measurement.

Run: python scripts/bench_scaling.py [--n-per-dev 65536]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-per-dev", type=int, default=65536)
    ap.add_argument("--virtual", action="store_true", default=None,
                    help="force the 8-virtual-CPU-device mesh")
    args = ap.parse_args()

    if args.virtual or os.environ.get("JAX_PLATFORMS") is None:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    import jax.numpy as jnp

    from flash_hash_join_tpu.parallel.mesh import data_mesh
    from flash_hash_join_tpu.parallel.distributed_join import (
        build_distributed_join, shard_columns)
    from flash_hash_join_tpu.utils import u64

    ndev_all = len(jax.devices())
    print(f"devices: {ndev_all} x {jax.devices()[0].platform}", flush=True)

    widths = [w for w in (1, 2, 4, 8) if w <= ndev_all]
    base_rate = None
    for ndev in widths:
        mesh = data_mesh(ndev)
        nb = args.n_per_dev * ndev        # weak scaling: fixed per-device
        npr = 4 * args.n_per_dev * ndev
        rng = np.random.default_rng(99)
        bk = rng.integers(0, 2**62, nb, dtype=np.uint64)
        bv = rng.integers(0, 2**62, nb, dtype=np.uint64)
        pk = np.concatenate([
            rng.choice(bk, npr // 2),
            rng.integers(0, 2**62, npr - npr // 2, dtype=np.uint64)])
        expected = int(np.isin(pk, np.unique(bk)).sum())

        fn = build_distributed_join(mesh, nb // ndev, npr // ndev)
        cols = [jnp.asarray(x) for x in
                (*u64.split_u64(bk), *u64.split_u64(bv), *u64.split_u64(pk))]
        args_dev = shard_columns(mesh, cols)
        sc = (jnp.int32(nb), jnp.int32(npr))
        count, overflow = fn(*args_dev, *sc)
        assert int(overflow) == 0
        assert int(count) == expected, (int(count), expected)
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            c, _ = fn(*args_dev, *sc)
            c.block_until_ready()
            best = min(best, time.perf_counter() - t0)
        rate = npr / best
        if base_rate is None:
            base_rate = rate / ndev
        eff = rate / (base_rate * ndev)
        print(f"ndev={ndev}: count={int(count)} OK  {best*1e3:8.1f} ms  "
              f"{rate/1e6:7.1f} M rows/s  weak-scaling eff={eff:.2f}",
              flush=True)


if __name__ == "__main__":
    main()
