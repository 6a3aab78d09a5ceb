"""The port's optimizers (``repro_torch.train.optimizer``) against
``repro``'s on the CPU: the same parameter trees and gradients, made
with numpy from a seed, through five steps of each.

Tolerances: f32 leaves and moments within rtol 1e-6 (the same f32
expressions; the bias corrections' ``b ** t`` may round an ulp apart);
bf16 leaves and moments within one bf16 ulp.  Adafactor within rtol
1e-5: its means are sums that XLA and torch order differently, and
where the momentum cancels toward 0 its f32 value within 1e-6 of the
leaf's largest; a bf16 momentum within 2^-7 of the leaf's largest (two
bf16 ulps of it: a rounding carried from an earlier step and a new
one), and so the
parameters within lr x 2^-6, an ulp of a momentum up to 4 (the update
is clipped to RMS 1).  The chunked AdamW update is bit-equal to
the whole-leaf one."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.train import optimizer as joptim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

SHAPES = {"w": (3, 8, 12), "b": (12,), "m": {"x": (6, 10), "s": (5,)}}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _draw(rng, shapes, scale=1.0):
    """A numpy f32 tree of ``shapes``' structure, N(0, scale^2), its keys
    sorted as a pytree orders them (``repro``'s trees come back so)."""
    return {k: (_draw(rng, v, scale) if isinstance(v, dict)
                else (scale * rng.normal(size=v)).astype(np.float32))
            for k, v in sorted(shapes.items())}


def _pair(tree, dtype):
    """A numpy f32 tree as the port's tensors and ``repro``'s arrays of
    ``dtype`` (bf16 rounded once, by torch, and carried exactly), each
    its own copy: the port updates its tensors in place, and JAX on the
    CPU may alias a numpy buffer."""
    tdt, jdt = DTYPES[dtype]
    ours = tree_map(lambda a: torch.tensor(a).to(tdt), tree)
    theirs = tree_map(
        lambda t: jnp.array(t.float().numpy(), copy=True).astype(jdt), ours)
    return ours, theirs


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ordered(a):
    """bf16 values as integers in their order (one apart = one ulp)."""
    bits = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).view(
        torch.int16).numpy().astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def _close(got, want, dtype, rtol=1e-6, atol=1e-30):
    g, w = _np(got), _np(want)
    if dtype == "bf16":
        ulps = np.abs(_ordered(g) - _ordered(w)).max()
        assert ulps <= 1, f"{ulps} bf16 ulps apart"
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _close_trees(got, want, dtype, rtol=1e-6, atol=1e-30):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        _close(g, w, dtype, rtol, atol)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("leaves", ["f32", "bf16"])
def test_adamw_matches_reference(leaves, moments):
    rng = np.random.default_rng(0)
    params, jparams = _pair(_draw(rng, SHAPES), leaves)
    opt = optimizer.adamw_init(params, DTYPES[moments][0])
    jopt = joptim.adamw_init(jparams, DTYPES[moments][1])
    for step in range(5):
        grads, jgrads = _pair(_draw(rng, SHAPES, 0.1 * (step + 1)), leaves)
        params, opt = optimizer.adamw_update(grads, opt, params, lr=3e-3)
        jparams, jopt = joptim.adamw_update(jgrads, jopt, jparams, lr=3e-3)
        _close_trees(params, jparams, leaves)
        _close_trees(opt.m, jopt.m, moments)
        _close_trees(opt.v, jopt.v, moments)
        assert int(opt.step) == int(jopt.step) == step + 1
        assert opt.step.dtype == torch.int32


@pytest.mark.parametrize("leaves", ["f32", "bf16"])
def test_adamw_chunked_is_bit_equal_to_whole_leaves(leaves, monkeypatch):
    rng = np.random.default_rng(1)
    shapes = {"stack": (4, 16, 40), "flat": (7, 9)}
    start = _draw(rng, shapes)
    grads = [_pair(_draw(rng, shapes), leaves)[0] for _ in range(3)]
    runs = []
    for chunk_bytes in (optimizer._CHUNK_BYTES, 1024):
        monkeypatch.setattr(optimizer, "_CHUNK_BYTES", chunk_bytes)
        params = _pair(start, leaves)[0]
        opt = optimizer.adamw_init(params)
        for g in grads:
            params, opt = optimizer.adamw_update(g, opt, params)
        runs.append((params, opt))
    (whole, opt_w), (chunked, opt_c) = runs
    for a, b in zip(tree_leaves((whole, opt_w)), tree_leaves((chunked,
                                                               opt_c))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("momentum", ["f32", "bf16"])
@pytest.mark.parametrize("chunk_bytes", [None, 1024],
                         ids=["whole", "chunked"])
def test_adafactor_matches_reference(momentum, chunk_bytes, monkeypatch):
    """A factored [L, a, b] leaf, a factored matrix and two rank-1
    leaves; chunked, both packages take the update RMS per slice."""
    LR = 1e-2
    if chunk_bytes is not None:
        monkeypatch.setattr(optimizer, "_CHUNK_BYTES", chunk_bytes)
        monkeypatch.setattr(joptim, "_CHUNK_BYTES", chunk_bytes)
    rng = np.random.default_rng(2)
    params, jparams = _pair(_draw(rng, SHAPES), "f32")
    opt = optimizer.adafactor_init(params, DTYPES[momentum][0])
    jopt = joptim.adafactor_init(jparams, DTYPES[momentum][1])
    for a, b in zip(tree_leaves(opt), tree_leaves(jopt)):
        assert tuple(a.shape) == b.shape and _np(a).dtype == np.float32
    for step in range(5):
        grads, jgrads = _pair(_draw(rng, SHAPES, 0.1 * (step + 1)), "f32")
        params, opt = optimizer.adafactor_update(grads, opt, params, lr=LR)
        jparams, jopt = joptim.adafactor_update(jgrads, jopt, jparams, lr=LR)
        _close_trees(params, jparams, "f32", rtol=1e-5,
                     atol=LR * 2**-6 if momentum == "bf16" else 1e-30)
        for f in ("vr", "vc", "v"):
            _close_trees(getattr(opt, f), getattr(jopt, f), "f32", rtol=1e-5)
        for m, jm in zip(tree_leaves(opt.m), tree_leaves(jopt.m)):
            scale = float(np.abs(_np(jm)).max())
            _close(m, jm, "f32", rtol=1e-5,
                   atol=(1e-6 if momentum == "f32" else 2**-7) * scale)
        assert int(opt.step) == int(jopt.step) == step + 1


def test_adagrad_matches_reference():
    rng = np.random.default_rng(3)
    params, jparams = _pair(_draw(rng, SHAPES), "f32")
    opt = optimizer.adagrad_init(params)
    jopt = joptim.adagrad_init(jparams)
    for step in range(5):
        grads, jgrads = _pair(_draw(rng, SHAPES), "f32")
        # a row no example touched: a zero gradient leaves it as it was
        grads["w"][1].zero_()
        jgrads["w"] = jgrads["w"].at[1].set(0.0)
        params, opt = optimizer.adagrad_update(grads, opt, params)
        jparams, jopt = joptim.adagrad_update(jgrads, jopt, jparams)
        _close_trees(params, jparams, "f32")
        _close_trees(opt.accum, jopt.accum, "f32")


@pytest.mark.parametrize("kind", ["adamw", "adafactor", "adagrad"])
def test_states_carry_across_and_continue(kind):
    """``convert.opt_state_from_numpy`` carries ``repro``'s state after two
    steps; a third step from it matches ``repro``'s third."""
    rng = np.random.default_rng(4)
    params, jparams = _pair(_draw(rng, SHAPES), "f32")
    init, update = (getattr(joptim, f"{kind}_init"),
                    getattr(joptim, f"{kind}_update"))
    jopt = init(jparams, jnp.bfloat16) if kind == "adamw" else init(jparams)
    for _ in range(2):
        jgrads = _pair(_draw(rng, SHAPES), "f32")[1]
        jparams, jopt = update(jgrads, jopt, jparams)
    opt = convert.opt_state_from_numpy(_numpy_state(jopt), device="cpu")
    assert type(opt).__name__ == type(jopt).__name__
    assert type(opt) is getattr(optimizer, type(jopt).__name__)
    params = tree_map(lambda a: torch.from_numpy(np.array(a)), jparams)
    grads, jgrads = _pair(_draw(rng, SHAPES), "f32")
    params, opt = getattr(optimizer, f"{kind}_update")(grads, opt, params)
    jparams, jopt = update(jgrads, jopt, jparams)
    _close_trees(params, jparams, "f32", rtol=1e-5)
    for a, b in zip(tree_leaves(opt), tree_leaves(_numpy_state(jopt))):
        assert a.dtype == _torch_dtype(b)
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   rtol=1e-5, atol=1e-30)


def _numpy_state(state):
    """A ``repro`` state with numpy leaves (bf16 kept as ``ml_dtypes``)."""
    return type(state)(*(tree_map(np.asarray, getattr(state, f))
                         for f in state._fields))


def _torch_dtype(a):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int32": torch.int32}[np.asarray(a).dtype.name]
