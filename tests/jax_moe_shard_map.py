"""The JAX package's own sharded MoE, ``_moe_apply_shard_map``, on host
devices: the reference that ``tests/test_torch_moe_tensor_parallel.py``
holds each rank's MoE layer to.

    python tests/jax_moe_shard_map.py IN.npz OUT.npz

``IN.npz`` holds, for each case ``c`` (``c`` = 0, 1, ...), ``c/E`` (the
expert count of tiny moonshot), ``c/mesh`` (data, model), the layer's
``c/router``, ``c/wi``, ``c/wo`` and inputs ``c/x/<i>`` (B, S, d);
``OUT.npz`` gets ``c/y/<i>``. Where an input has a cotangent ``c/dy/<i>``
(B, S, d) beside it, ``OUT.npz`` also gets the gradient of ``sum(y ·
dy)`` through the sharded MoE (``jax.grad``, the reference's own
differentiation of its ``shard_map``) in ``c/g/<i>/router``,
``c/g/<i>/wi``, ``c/g/<i>/wo`` and ``c/g/<i>/x``, each of the whole
leaf. Four host devices are forced before JAX starts, so this runs in a
process of its own.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs.archs import tiny_version  # noqa: E402
from repro.configs.base import get_config  # noqa: E402
from repro.models import transformer as T  # noqa: E402


def main(src: str, dst: str) -> None:
    inp = np.load(src)
    out = {}
    n_cases = len({k.split("/")[0] for k in inp.files})
    for c in range(n_cases):
        cfg = tiny_version(get_config("moonshot-v1-16b-a3b")).with_(
            n_experts=int(inp[f"{c}/E"]))
        shape = tuple(int(n) for n in inp[f"{c}/mesh"])
        mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(
            shape), ("data", "model"))
        p = {"router": {"kernel": inp[f"{c}/router"]}, "wi": inp[f"{c}/wi"],
             "wo": inp[f"{c}/wo"]}
        run = jax.jit(lambda p, x: T._moe_apply_shard_map(p, cfg, x, mesh))
        grad = jax.jit(jax.grad(
            lambda p, x, dy: (run(p, x) * dy).sum(), argnums=(0, 1)))
        xs = sorted(k for k in inp.files if k.startswith(f"{c}/x/"))
        for k in xs:
            out[k.replace("/x/", "/y/")] = np.asarray(run(p, inp[k]))
            dy = k.replace("/x/", "/dy/")
            if dy not in inp.files:
                continue
            gp, gx = grad(p, inp[k], inp[dy])
            g = k.replace("/x/", "/g/")
            out.update({f"{g}/router": np.asarray(gp["router"]["kernel"]),
                        f"{g}/wi": np.asarray(gp["wi"]),
                        f"{g}/wo": np.asarray(gp["wo"]),
                        f"{g}/x": np.asarray(gx)})
    np.savez(dst, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
