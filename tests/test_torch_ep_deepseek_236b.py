"""DeepSeek-V2-236B on the paper's expert-parallel 2x2 world (pod x data)
against the JAX package.

DeepSeek-V2-236B is the configuration the paper's topology-aware
dispatch exists for: no one card holds it.  Its ``reduced()`` variant
differs from DeepSeek-V2-Lite's only in the low-rank query branch,
which ``reduced()`` cuts to 0; here it is kept (``q_lora_rank=32``: the
``w_dq`` / ``q_norm`` / ``w_uq`` leaves), and the model is widened as
``tests/test_torch_ep_families.py`` widens DeepSeek-V2-Lite: 8 experts
(2 a rank), top-6, 2 shared experts, 3 layers (a dense first layer, then
two MoE layers; MLA in every one), capacity factor 1.25 as the config's.

One JAX subprocess on 4 forced host devices (mesh ``(2, 2, 1)`` over
``("pod", "data", "model")``, ``aux_mode="ta"``) computes, beside 4 CPU
processes of the port joined over gloo (``launch.mesh.spawn``):

- the Eq. (7) plan and, on each MoE layer, every rank's top-6 picks and
  its dispatch indices (``route`` + ``build_indices`` on the rank's
  rows);
- through ``_moe_block`` on each MoE layer, the output, the metrics and
  the gradients of ``sum(y * r) + aux_loss``, the kernels wanted and not;
- ``loss_fn`` on a batch with a loss mask: the loss, its metrics and
  every synced gradient (the low-rank query leaves among MLA's, summed
  over the whole world; the routed experts' gathered over the EP axes);
- 3 ``a2a`` trainer steps;
- greedy ``ServingEngine.run`` on the ``(4, 1)`` data x model mesh that
  ``repro.launch.serve --mesh-shape 4,1`` builds, every MoE layer
  through ``gather`` (MLA's latent cache in the slots).

Tolerance: rtol = atol = 1e-4 (float32, the sums run in another order);
final params atol 2e-4 (``test_torch_training.py``); picks, dispatch
indices and greedy tokens exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_ep_families import (BATCH, BUDGETS,  # noqa: E402
                                    HISTORY_KEYS, MOE_LAYERS, SEQ, SIZES,
                                    STEPS, _arch, _ref_leaves, _world,
                                    check_moe_layers, close, mixer_leaves,
                                    run_world)

# the architecture, as text both packages evaluate on their own configs
ARCH = ("dataclasses.replace(get_config('deepseek_v2_236b').reduced(), "
        "num_layers=3, moe=dataclasses.replace(get_config("
        "'deepseek_v2_236b').reduced().moe, num_experts=8, top_k=6, "
        "num_shared_experts=2), mla=dataclasses.replace(get_config("
        "'deepseek_v2_236b').reduced().mla, q_lora_rank=32))")
KEY = "dsv2_236b"
# the low-rank query branch's leaves of every layer's MLA
Q_LORA = ("w_dq", "w_uq", "q_norm")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [rank 0..3 results]) — one JAX subprocess and,
    beside it once it has made the weights, batch and prompts, one
    4-process gloo world of the port (``test_torch_ep_families.
    run_world``, with the picks and the ranks' own low-rank query
    gradients)."""
    return run_world(tmp_path_factory.mktemp("ep_deepseek_236b"),
                     {KEY: ARCH}, KEY, 6, picks=True, local_leaves=Q_LORA)


def test_plan_and_top6_picks_match_reference(runs):
    """The Eq. (7) plan (both stages live), each rank's experts (2r, 2r +
    1), and on both MoE layers every rank's top-6 picks, slot-to-token map
    and inverse index, exactly; top-6 of 8 at capacity factor 1.25 drops
    picks at this plan's capacities."""
    ref, ranks = runs
    caps = ref["caps"][KEY]
    assert len(caps) == 2 and min(caps) > 0
    for r, out in enumerate(ranks):
        assert out["coords"] == divmod(r, SIZES[1])
        assert out["caps"][KEY] == caps
        assert out["expert_range"][KEY] == out["serve_expert_range", KEY] \
            == (2 * r, 2 * r + 2)
    for layer in MOE_LAYERS:
        want = ref["picks", layer]
        assert want[0].shape[-1] == 6
        for r, out in enumerate(ranks):
            for got, w in zip(out["picks", layer], want):
                np.testing.assert_array_equal(got, w[r])
        assert float(ref["moe", layer]["metrics"]["dropped"]) > 0


def test_moe_layers_match_reference(runs):
    """Both MoE layers, the kernels wanted and not: the output, the
    world-mean metrics, and the gradients of the input, the gate, each
    rank's routed experts and the shared experts (summed over the
    world)."""
    check_moe_layers(*runs)


def _q_lora_index(grads):
    """``[(layer, leaf name)]`` and the leaf positions of the low-rank
    query leaves in the port's order of the reference tree ``grads``."""
    from repro_torch.models import model
    from repro_torch.models.convert import params_from_numpy
    ctx = model.build_ctx(_arch(ARCH), seq_len=SEQ, global_batch=BATCH,
                          device="cpu")
    names, is_q = mixer_leaves(params_from_numpy(grads, ctx, "cpu"), Q_LORA)
    return names, [i for i, q in enumerate(is_q) if q]


def test_loss_and_every_synced_gradient_match_reference(runs):
    """``loss_fn`` on the world with a loss mask, the kernels wanted and
    not: the world-mean loss and metrics, and every gradient after
    ``trainer.sync_grads`` (MLA's, the low-rank query branch's among
    them, the dense layer's, the shared experts' and the gate's summed
    over the world; the routed experts' gathered over the EP axes)."""
    ref, ranks = runs
    want = ref["loss"]
    wgrads = _ref_leaves(ARCH, want["grads"])
    names, _ = _q_lora_index(want["grads"])
    assert sorted({n for _, n in names}) == sorted(Q_LORA)
    assert {layer for layer, _ in names} == {"0", "1", "2"}
    for use_pallas in (False, True):
        for out in ranks:
            got = out["loss", use_pallas]
            close(got["metrics"]["loss"], want["loss"])
            for k in want["metrics"]:
                close(got["metrics"][k], want["metrics"][k])
            assert len(got["grads"]) == len(wgrads)
            for g, w in zip(got["grads"], wgrads):
                close(g, w)


def test_q_lora_leaves_are_replicated_and_summed_over_the_world(runs):
    """The low-rank query leaves (``w_dq``, ``q_norm``, ``w_uq`` of each
    of the 3 layers) are no expert leaves (``trainer.expert_mask``), and
    their synced gradient is the sum of the four ranks' own, equal to the
    reference's full gradient, where one rank's alone is not."""
    ref, ranks = runs
    wgrads = _ref_leaves(ARCH, ref["loss"]["grads"])
    _, q_idx = _q_lora_index(ref["loss"]["grads"])
    assert len(q_idx) == 3 * len(Q_LORA)
    for use_pallas in (False, True):
        got = [out["loss", use_pallas] for out in ranks]
        mask = got[0]["expert_mask"]
        assert any(mask) and not any(mask[i] for i in q_idx)
        for n, i in enumerate(q_idx):
            local = [g["local"][n] for g in got]
            close(np.sum(local, axis=0), wgrads[i])
            for g in got:
                close(g["grads"][i], wgrads[i])
            assert not np.allclose(local[0], wgrads[i], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("use_pallas", [None, True])
def test_trainer_matches_reference(runs, use_pallas):
    """3 ``a2a`` steps on the world: every logged metric on every rank,
    and each rank's final parameters (atol 2e-4)."""
    ref, ranks = runs
    want = ref["train", KEY]
    assert len(want["history"]) == STEPS
    for out in ranks:
        got = out["train", KEY, use_pallas]
        assert len(got["history"]) == STEPS
        for a, b in zip(got["history"], want["history"]):
            for k in HISTORY_KEYS:
                close(a[k], b[k])
        final = _ref_leaves(ARCH, want["final"], _world(out))
        assert len(final) == len(got["final"])
        for a, b in zip(got["final"], final):
            close(a, b, rtol=1e-4, atol=2e-4)


def test_gather_serving_tokens_match_reference(runs):
    """``ServingEngine.run`` on the world, greedy, every MoE layer through
    ``gather`` with MLA's latent cache (and its low-rank query branch) in
    the world's slots: every rank's streams are the reference engine's on
    the (4, 1) mesh, exactly."""
    ref, ranks = runs
    for out in ranks:
        assert out["served", KEY] == ref["served", KEY]
    assert sum(len(v) for v in ref["served", KEY].values()) == sum(BUDGETS)
