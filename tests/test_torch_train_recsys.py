"""The port's recsys training losses against ``repro``'s on the CPU:
``dcn_loss`` (through the cross kernel's autograd Function),
``sampled_softmax_loss`` (SASRec, BERT4Rec) and ``mind_loss`` with their
gradients, and Adagrad steps of DCN-v2.  The same numpy parameters
(carried by ``repro_torch.convert``) and inputs go through both
packages; the sampled losses get ``repro``'s negatives.

Tolerances: losses within 1e-5 relative; gradients within rtol 1e-4 and
atol 1e-5 x the leaf's largest |g|; Adagrad's parameters within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models.recsys import dcn_v2 as jdcn  # noqa: E402
from repro.models.recsys import mind as jmind  # noqa: E402
from repro.models.recsys import seqrec as jseqrec  # noqa: E402
from repro.train import optimizer as joptim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.recsys import dcn_v2, mind, seqrec  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_train import _grads_close, _loss_close, _numpy_tree  # noqa: E402,E501


# --- the recsys losses ------------------------------------------------------------


def _dcn_pair(seed=0):
    jcfg = jdcn.DCNConfig(vocab_per_field=64, embed_dim=4,
                          mlp_dims=(32, 16))
    cfg = dcn_v2.DCNConfig(vocab_per_field=64, embed_dim=4,
                           mlp_dims=(32, 16))
    params = jdcn.init_dcn(jax.random.PRNGKey(seed), jcfg)
    model = convert.dcn_from_numpy(_numpy_tree(params), cfg, device="cpu")
    return jcfg, params, model.requires_grad_(True)


def _dcn_batch(rng, cfg, B):
    return (rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
            rng.integers(0, cfg.vocab_per_field, (B, cfg.n_sparse))
            .astype(np.int32),
            (rng.random(B) < 0.3).astype(np.float32))


def _torch_batch(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def test_dcn_loss_and_grads_match_reference():
    jcfg, params, model = _dcn_pair()
    batch = _dcn_batch(np.random.default_rng(5), jcfg, 24)
    want, jgrads = jax.value_and_grad(jdcn.dcn_loss)(
        params, jcfg, *map(jnp.asarray, batch))
    got, grads = train.value_and_grad(dcn_v2.dcn_loss, model.tree(), model,
                                      *_torch_batch(batch))
    _loss_close(got, want)
    _grads_close(grads, jgrads)


SEQ = dict(n_items=256, embed_dim=16, n_blocks=2, n_heads=2, seq_len=12,
           n_negatives=15)
MIND_CFG = dict(n_items=256, embed_dim=16, n_interests=3, capsule_iters=3,
                seq_len=10, n_negatives=15)


@pytest.mark.parametrize("arch", ["sasrec", "bert4rec", "mind"])
def test_sampled_softmax_losses_match_reference(arch):
    """With ``repro``'s negatives, drawn by the same ``jax.random.randint``
    call its loss makes, handed to the port's."""
    if arch == "mind":
        jcfg = jmind.MINDConfig(**MIND_CFG)
        cfg = mind.MINDConfig(**MIND_CFG)
        params = jmind.init_mind(jax.random.PRNGKey(6), jcfg)
        model = convert.mind_from_numpy(_numpy_tree(params), cfg,
                                        device="cpu")
        jloss_fn, loss_fn = jmind.mind_loss, mind.mind_loss
    else:
        causal = arch == "sasrec"
        jcfg = jseqrec.SeqRecConfig(causal=causal, **SEQ)
        cfg = seqrec.SeqRecConfig(causal=causal, **SEQ)
        params = jseqrec.init_seqrec(jax.random.PRNGKey(6), jcfg)
        model = convert.seqrec_from_numpy(_numpy_tree(params), cfg,
                                          device="cpu")
        jloss_fn, loss_fn = (jseqrec.sampled_softmax_loss,
                             seqrec.sampled_softmax_loss)
    model.requires_grad_(True)
    rng = np.random.default_rng(7)
    hist = rng.integers(1, cfg.n_items, (4, cfg.seq_len)).astype(np.int32)
    hist[0, :3] = 0                       # pads: weigh nothing, route nowhere
    tgt = (rng.integers(0, cfg.n_items, (4,)) if arch == "mind"
           else np.where(rng.random(hist.shape) < 0.2, 0, hist)).astype(
               np.int32)
    key = jax.random.PRNGKey(8)
    neg = np.asarray(jax.random.randint(key, (cfg.n_negatives,), 0,
                                        cfg.n_items))
    want, jgrads = jax.value_and_grad(jloss_fn)(
        params, jcfg, jnp.asarray(hist), jnp.asarray(tgt), key)
    got, grads = train.value_and_grad(
        lambda *a: loss_fn(*a, negatives=torch.tensor(neg)),
        model.tree(), model, torch.from_numpy(hist), torch.from_numpy(tgt))
    _loss_close(got, want)
    _grads_close(grads, jgrads)
    # the port's own draw: a generator's uniform ids in range
    g = torch.Generator().manual_seed(0)
    own = loss_fn(model, torch.from_numpy(hist), torch.from_numpy(tgt), g)
    assert bool(torch.isfinite(own))


def test_adagrad_steps_of_dcn_match_reference():
    """Three Adagrad steps (lr 1e-2) of DCN-v2 at reduced width on the
    same batches: losses within 1e-5 relative, parameters within 1e-5."""
    jcfg, params, model = _dcn_pair(1)

    @jax.jit
    def jstep(params, opt, dense, sparse, labels):
        loss, g = jax.value_and_grad(jdcn.dcn_loss)(params, jcfg, dense,
                                                    sparse, labels)
        params, opt = joptim.adagrad_update(g, opt, params)
        return params, opt, loss

    jopt = joptim.adagrad_init(params)
    tree = model.tree()
    opt = optimizer.adagrad_init(tree)
    rng = np.random.default_rng(9)
    for _ in range(3):
        batch = _dcn_batch(rng, jcfg, 32)
        params, jopt, want = jstep(params, jopt, *map(jnp.asarray, batch))
        tree, opt, got = train.recsys_step(dcn_v2.dcn_loss, model, tree, opt,
                                           _torch_batch(batch))
        _loss_close(got, want)
    for g, w in zip(tree_leaves((tree, opt)), jax.tree.leaves((params,
                                                                jopt))):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
