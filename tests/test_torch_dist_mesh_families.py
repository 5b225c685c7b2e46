"""Every family's placed train step on a mesh of 8 CPU ranks.

The train step of every config in ARCHS at smoke width, on a (data 2,
model 4) mesh of 8 gloo ranks with the dry-run plan's ``head_tp``
(``act_batch_axes=("data",)``, ``act_model_axis="model"``), held to the
port's one-device run of the same bits and batch in this process, in
tests/test_torch_dist.py's bands: the loss within rtol 1e-5, AdamW's first
moments within 1e-4 of each leaf's largest |value|, the parameters within
5e-4 of it except where the gradient lies inside its band of zero
(``check_step``). The families reach every ``local_map`` site of the
models: the attention Function and its GQA kv heads, the products' tensor
parallelism, the MoE's groups on the batch shard (granite-moe,
llama4-scout), the Mamba2 mixer (zamba2), the mLSTM and sLSTM mixers
(xlstm), the audio frame features (hubert) and the vision prefix
(paligemma). One world of ranks runs every family in turn
(``torch_dist_worlds.world_families``).
"""
import numpy as np
import pytest
import torch

import torch_dist_worlds as worlds
from repro_torch import configs
from repro_torch.configs.base import InnerOptConfig
from repro_torch.dist import steps
from repro_torch.models import Model
from test_torch_dist import INNER, check_step
from test_torch_methods import one_intra_op_thread  # noqa: F401

B, S = 4, 16


def family_batch(cfg, seed):
    """A smoke batch of (B, S) positions for ``cfg``'s frontend: tokens, or
    frame features (audio), or a patch prefix before the tokens (vision),
    with next-token labels; numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    if cfg.frontend.kind == "audio":
        return {"features": rng.normal(size=(B, S, cfg.d_model))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S))
                .astype(np.int32)}
    n = S - (cfg.frontend.n_prefix_tokens
             if cfg.frontend.kind == "vision" else 0)
    tok = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    out = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    if cfg.frontend.kind == "vision":
        out["patches"] = rng.normal(size=(
            B, cfg.frontend.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 8-rank results, the one-device results) by arch."""
    cases, want = {}, {}
    inner = InnerOptConfig(**INNER)
    for i, arch in enumerate(configs.ARCHS):
        cfg = worlds.planned(configs.reduced(configs.get_config(arch)))
        params = Model(cfg).init(torch.Generator().manual_seed(i), "cpu")
        batch = family_batch(cfg, i)
        cases[arch] = (cfg, {k: v.numpy() for k, v in params.items()},
                       batch)
        st, loss = steps.make_train_step(cfg, inner, q_chunk=16)(
            steps.init_train_state(params),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        want[arch] = (float(loss), {k: v.numpy() for k, v in
                                    st.params.items()},
                      {k: v.numpy() for k, v in st.opt.mu.items()})
    got = worlds.spawn(worlds.world_families, 8,
                       tmp_path_factory.mktemp("families"),
                       {"inner": INNER, "cases": cases})
    return got, want


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_every_family_trains_placed_on_eight_ranks(runs, arch):
    got, want = runs
    loss, params, mu, sharded = got[arch]
    wloss, wparams, wmu = want[arch]
    np.testing.assert_allclose(loss, wloss, rtol=1e-5, err_msg=arch)
    assert set(params) == set(wparams)
    for k, v in wmu.items():
        np.testing.assert_allclose(mu[k], v, rtol=0,
                                   atol=1e-4 * np.abs(v).max() + 1e-12,
                                   err_msg=f"{arch} {k}")
    check_step(params, wparams, wmu, INNER["lr"], InnerOptConfig().
               weight_decay, arch)
    # the step's state stays placed: at least the projections are shards
    assert sharded > 0, arch
