#!/usr/bin/env python3
"""The JAX step's gradient norm on a ``(data, model)`` mesh under each
parameter placement, on the CPU (8 forced host devices).

    python3 scripts/jax_tp_placement_grads.py

Runs ``make_train_step`` (the JAX package) twice, on the inputs of
``tests/test_torch_tp_step.py`` (a 32-wide CLIP, DINO-soft, 4 rows a data
rank), on the ``(2, 1)`` and ``(2, 2)`` meshes with the state placed
replicated, by the model-axis rules alone (``state_shardings(state,
mesh)``), with ZeRO-1 (``shard_opt_state=True``) and with FSDP
(``fsdp=True``), ``min_size=0``. Prints one line a placement: the two
steps' ``grad_norm`` and ``total_loss``. Sharding should move bytes only,
so every line should agree; see ROADMAP Queue 3 for where they do not.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from refining_clip_via_dinov2_representations_tpu.parallel import mesh as jax_mesh  # noqa: E402
from tests import test_torch_tp_step as tp_step  # noqa: E402

PLACEMENTS = {
    "replicated": lambda state, mesh: jax.tree.map(lambda _: jax_mesh.replicated(mesh), state),
    "model axis only": lambda state, mesh: STATE_SHARDINGS(state, mesh),
    "ZeRO-1": lambda state, mesh: STATE_SHARDINGS(state, mesh, shard_opt_state=True,
                                                  min_size=0),
    "FSDP": lambda state, mesh: STATE_SHARDINGS(state, mesh, fsdp=True, min_size=0),
}
STATE_SHARDINGS, CREATE_MESH = jax_mesh.state_shardings, jax_mesh.create_mesh


def main() -> None:
    inputs = tp_step._inputs()
    for model in (1, 2):
        jax_mesh.create_mesh = lambda data=None, model_=model, devices=None, **_: CREATE_MESH(
            data=data, model=model_, devices=jax.devices()[:data * model_])
        for name, place in PLACEMENTS.items():
            jax_mesh.state_shardings = lambda state, mesh, place=place: place(state, mesh)
            steps = tp_step._jax_run(inputs, 2, False)
            print(f"(2, {model}) {name}: grad_norm "
                  f"{[round(m['grad_norm'], 3) for m, _ in steps]}, total_loss "
                  f"{[round(m['total_loss'], 6) for m, _ in steps]}", flush=True)


if __name__ == "__main__":
    main()
