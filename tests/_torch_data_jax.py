"""JAX references for ``tests/test_torch_data.py`` (not a test module).

Run as ``python _torch_data_jax.py OUT PART`` under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` with ``src`` and
``tests`` on ``PYTHONPATH``: it builds the meshes ``(data 2, model 1)``
(PART ``2x1``) or ``(2, 2)`` and ``(pod 2, data 2, model 1)`` (PART
``2x2``) over the host devices and runs the JAX package's engine (its
rows split over the data axis, the page pool sharded over kv_seq only)
on the two-phase workload of ``_torch_sharded_inputs.engine_requests``
on both read paths, and ``generate`` on a dense cache; PART ``2x1`` also
a 3-row wave, PART ``2x2`` the tiny MoE target
under expert parallelism. The two parts run side by side. It writes
``OUT/ref_PART.npz`` (arrays) and ``OUT/ref_PART.json`` (tokens and
stats).
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from _torch_data_inputs import GEN_NEW, PAGE, generate_prompts
from _torch_ep_jax import moe_bundle
from _torch_sharded_inputs import engine_requests
from _torch_sharded_jax import bundle

from repro.core import pipeline as pl
from repro.distributed import sharding as sh
from repro.launch.mesh import make_mesh
from repro.serving.engine import ServingEngine

RULES = dict(sh.LOGICAL_RULES, kv_seq="model")
#: mesh name -> (data, model, pod)
MESHES = {"2x1": (2, 1, 1), "2x2": (2, 2, 1), "pod2x2": (2, 1, 2)}


def mesh(name):
    d, m, p = MESHES[name]
    return make_mesh(d, m, pod=p)


def serve(bun, impl, name, batch=2):
    """The two-phase workload through JAX's engine inside mesh ``name``:
    tokens and stats."""
    bun = pl.with_attn_impl(bun, impl)
    kw = dict(batch_size=batch, seed=0, cache_impl="paged", page_size=PAGE,
              prefix_cache=True, pool_scope="engine")
    with sh.use_sharding(mesh(name), RULES):
        eng = ServingEngine(bun, **kw)
    for part in engine_requests():
        for pr, n in part:
            eng.submit(pr, max_new=n)
        stats = eng.run()
    return {"tokens": {str(r.uid): r.out.tolist() for r in eng.done},
            "stats": {k: (float(v) if isinstance(v, float) else int(v))
                      for k, v in stats.items()}}


def main(out, part):
    assert jax.device_count() >= 4, jax.device_count()
    bun = bundle()
    meta = {"engine": {f"{part}/{impl}": serve(bun, impl, part)
                       for impl in ("gather", "pallas")}}
    if part == "2x1":
        meta["wave3"] = serve(bun, "gather", "2x1", batch=3)
    else:
        meta["moe"] = serve(moe_bundle(), "gather", "2x2")
    res = {}
    for name in (("2x1",) if part == "2x1" else ("pod2x2",)):
        with sh.use_sharding(mesh(name), RULES):
            res[f"generate/{name}"] = np.asarray(pl.generate(
                bun, jnp.asarray(generate_prompts()), GEN_NEW)["tokens"])
    out = Path(out)
    np.savez(out / f"ref_{part}.npz", **res)
    (out / f"ref_{part}.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    main(*sys.argv[1:])
