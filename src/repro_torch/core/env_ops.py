"""Shard-aware environment protocol for the stage engine and the
baselines.

An environment is two functions:

  contexts_fn(seed, step, occ, row0=0)                  -> [n_local, K, d]
  rewards_fn(seed, step, occ, contexts, choice, row0=0) -> (realized,
                                                           expected, best,
                                                           rand)

and two draws the sequential baselines make:

  user_fn(seed, step)        -> int   the user of CLUB's interaction
                                      ``step`` (a host int)
  peers_fn(seed, step, adj)  -> [n]   one uniformly drawn neighbour per
                                      row of DCCB's dense ``[n, n]`` bool
                                      graph at gossip round ``step`` (any
                                      value for a row with no neighbour)

``seed`` is the run's seed and ``step`` the run's global round id (epoch
``e``, stage ``s`` in {0: stage 1, 1: stage 3}, round ``t`` ->
``(2 e + s) * max_rounds + t``); together they take the place of the JAX
package's PRNG key.  ``occ`` is the per-user interaction count of a LOCAL
user slice and ``row0`` the global id of the slice's first user; CLUB
calls the functions on one user's slice, ``row0 = u``.

Four kinds, as in the reference: ``synthetic_ops`` (fresh unit contexts
against fixed preferences), ``drift_ops`` (the same contexts against
``env.drift_theta``, whose phase follows ``occ``), ``catalog_ops``
(slates of ``K`` items of a persistent catalog at the user's
``env.catalog_phase``) and ``replay_ops`` (a logged queue of slates and
click probabilities per user, ``occ`` its cursor, clamped to the last
slate).

Every random input of a round comes through one seam, a ``Draws``: the
unit contexts, the slate ids, the Bernoulli uniforms and CLUB's user.
``HASH_DRAWS`` is the port's own.  Each is keyed by (seed, step, GLOBAL
user id, slot) through a stateless counter hash (splitmix64 in int64
tensor arithmetic, then Box-Muller for normals), computed on the device,
so user ``u`` sees the same draws whatever slice of the user axis it is
computed in.  A slate id is the high 32 bits of the slate stream's hash,
``h``, mapped onto ``[0, N)`` by the multiply-shift ``(h * N) >> 32``
(exact in int64 for N <= 2**31).  Replay draws no contexts and ignores
the seed for them.  ``user_fn`` hashes (seed, step) on the host, so
CLUB's loop never waits for the card; ``peers_fn`` hashes (seed, step,
row) on the device.  ``tape_draws`` replays recorded draws instead (the
parity tests feed it the reference's own), and ``tape_ops`` is the
synthetic kind on a tape.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import torch

from . import env as synth_env

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MUL1 = 0xBF58476D1CE4E5B9
_MUL2 = 0x94D049BB133111EB
_STREAM_CONTEXTS = 1
_STREAM_REWARDS = 2
_STREAM_USERS = 3
_STREAM_PEERS = 4
_STREAM_SLATES = 5


def draw_user(seed: int, step: int, n: int) -> int:
    """A uniform user id in ``[0, n)`` for (seed, step), on the host."""
    bits = _splitmix(_key(seed, _STREAM_USERS, step))
    return (bits * n) >> 64


def draw_peers(seed: int, step: int, adj: torch.Tensor) -> torch.Tensor:
    """[n] i64: for each row of the dense ``[n, n]`` bool ``adj`` a
    uniformly drawn neighbour (its ``k``-th set column, ``k`` uniform
    below the row's degree); ``n - 1`` for a row with none."""
    n = adj.shape[0]
    z = _hash(seed, _STREAM_PEERS, step, _counters(0, n, 1, adj.device))
    u = _srl(z[:, 0], 11).double() * 2.0**-53           # [0, 1)
    deg = torch.sum(adj, dim=1, dtype=torch.int32)
    k = torch.minimum(torch.floor(u * deg).to(torch.int32),
                      torch.clamp_min(deg - 1, 0))
    pos = torch.cumsum(adj, dim=1, dtype=torch.int32)   # set bits so far
    peer = torch.searchsorted(pos, (k + 1)[:, None])[:, 0]
    return torch.clamp_max(peer, n - 1)


class EnvOps(NamedTuple):
    contexts_fn: Callable
    rewards_fn: Callable
    n_users: int
    d: int
    n_candidates: int
    user_fn: Callable
    peers_fn: Callable


def _signed(v: int) -> int:
    """A 64-bit pattern as the int64 value torch stores for it."""
    v &= _MASK64
    return v - (1 << 64) if v >> 63 else v


def _splitmix(z: int) -> int:
    """splitmix64 finalizer on a Python int (mod 2**64)."""
    z &= _MASK64
    z = ((z ^ (z >> 30)) * _MUL1) & _MASK64
    z = ((z ^ (z >> 27)) * _MUL2) & _MASK64
    return z ^ (z >> 31)


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _key(seed: int, stream: int, step: int) -> int:
    return _splitmix(_splitmix(_splitmix(seed) ^ stream) ^ step)


def _hash(seed: int, stream: int, step: int,
          counter: torch.Tensor) -> torch.Tensor:
    """64 random bits per int64 counter (splitmix64 of key + i * golden;
    int64 products wrap, which is the mod-2**64 arithmetic it needs)."""
    z = counter * _signed(_GOLDEN) + _signed(_key(seed, stream, step))
    z = (z ^ _srl(z, 30)) * _signed(_MUL1)
    z = (z ^ _srl(z, 27)) * _signed(_MUL2)
    return z ^ _srl(z, 31)


def _counters(row0: int, n_local: int, slots: int, device) -> torch.Tensor:
    """[n_local, slots] int64 global (user, slot) counters."""
    users = torch.arange(row0, row0 + n_local, dtype=torch.int64,
                         device=device)
    return users[:, None] * slots + torch.arange(slots, dtype=torch.int64,
                                                 device=device)


def _unit_contexts(seed, step, n_local, K, d, row0, device):
    z = _hash(seed, _STREAM_CONTEXTS, step,
              _counters(row0, n_local, K * d, device))
    u1 = (_srl(z, 40) + 1).float() * 2.0**-24        # (0, 1]
    u2 = (z & 0xFFFFFF).float() * 2.0**-24           # [0, 1)
    x = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2 * math.pi) * u2)
    x = x.reshape(n_local, K, d)
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def _uniforms(seed, step, n_local, row0, device):
    z = _hash(seed, _STREAM_REWARDS, step, _counters(row0, n_local, 1, device))
    return _srl(z[:, 0], 40).float() * 2.0**-24      # [0, 1)


def _slate_ids(seed, step, n_local, K, N, row0, device):
    """[n_local, K] i64 item ids in ``[0, N)``: multiply-shift of the
    hash's high 32 bits."""
    z = _hash(seed, _STREAM_SLATES, step, _counters(row0, n_local, K, device))
    return (_srl(z, 32) * N) >> 32


class Draws(NamedTuple):
    """The random inputs of an environment's round, the one seam through
    which every kind draws:

      contexts(seed, step, n_local, K, d, row0, device) -> [n_local, K, d]
                                                           unit rows
      slate(seed, step, n_local, K, N, row0, device)    -> [n_local, K] i64
                                                           ids in [0, N)
      uniforms(seed, step, n_local, row0, device)       -> [n_local]
      user(seed, step, n)                               -> host int
    """

    contexts: Callable
    slate: Callable
    uniforms: Callable
    user: Callable


HASH_DRAWS = Draws(_unit_contexts, _slate_ids, _uniforms, draw_user)


def tape_draws(uniforms: torch.Tensor, contexts: torch.Tensor | None = None,
               slates: torch.Tensor | None = None, users=None) -> Draws:
    """Recorded draws of global rounds ``0..S-1``: Bernoulli ``uniforms
    [S, n]``, unit ``contexts [S, n, K, d]`` and catalog ``slates [S, n,
    K]`` where given (the kinds that draw them need them), CLUB's
    ``users [S]`` (host ints; else ``draw_user``'s).  The seed is
    ignored."""

    def tape_contexts(seed, step, n_local, K, d, row0, device):
        return contexts[step, row0:row0 + n_local]

    def tape_slate(seed, step, n_local, K, N, row0, device):
        return slates[step, row0:row0 + n_local].long()

    def tape_uniforms(seed, step, n_local, row0, device):
        return uniforms[step, row0:row0 + n_local]

    def tape_user(seed, step, n):
        return int(users[step])

    return Draws(tape_contexts, tape_slate, tape_uniforms,
                 draw_user if users is None else tape_user)


def _ops(contexts_fn, rewards_fn, n, d, K, draws: Draws) -> EnvOps:
    return EnvOps(contexts_fn, rewards_fn, n, d, K,
                  functools.partial(draws.user, n=n), draw_peers)


def synthetic_ops(env: synth_env.SyntheticEnv,
                  draws: Draws = HASH_DRAWS) -> EnvOps:
    n, d, K = env.n_users, env.d, env.n_candidates
    theta = env.theta

    def contexts_fn(seed, step, occ, row0=0):
        return draws.contexts(seed, step, occ.shape[0], K, d, row0,
                              occ.device)

    def rewards_fn(seed, step, occ, contexts, choice, row0=0):
        th = theta[row0:row0 + occ.shape[0]]
        u = draws.uniforms(seed, step, occ.shape[0], row0, occ.device)
        return synth_env.step_rewards(u, th, contexts, choice)

    return _ops(contexts_fn, rewards_fn, n, d, K, draws)


def drift_ops(env: synth_env.DriftEnv, draws: Draws = HASH_DRAWS) -> EnvOps:
    """The non-stationary kind: contexts as the synthetic kind's, click
    probabilities against ``drift_theta`` at each user's own ``occ``."""
    n, d, K = env.n_users, env.d, env.n_candidates

    def contexts_fn(seed, step, occ, row0=0):
        return draws.contexts(seed, step, occ.shape[0], K, d, row0,
                              occ.device)

    def rewards_fn(seed, step, occ, contexts, choice, row0=0):
        th = synth_env.drift_theta(env, occ, row0)
        u = draws.uniforms(seed, step, occ.shape[0], row0, occ.device)
        return synth_env.step_rewards(u, th, contexts, choice)

    return _ops(contexts_fn, rewards_fn, n, d, K, draws)


def catalog_ops(env: synth_env.CatalogEnv,
                draws: Draws = HASH_DRAWS) -> EnvOps:
    """The fixed-catalog kind for the offline drivers: each round's slate
    is ``K`` ids of the persistent catalog (``draws.slate``), embedded at
    the user's ``catalog_phase``, so stages 1 and 3 learn against the item
    population catalog serving reads."""
    n, d, K, N = env.n_users, env.d, env.n_candidates, env.n_items
    theta = env.theta
    region = env.item_region.long()

    def contexts_fn(seed, step, occ, row0=0):
        ids = draws.slate(seed, step, occ.shape[0], K, N, row0, occ.device)
        phase = synth_env.catalog_phase(env, occ).long()
        e = env.region_centroids[phase[:, None], region[ids]] \
            + env.item_noise[ids]
        return e / torch.linalg.norm(e, dim=-1, keepdim=True)

    def rewards_fn(seed, step, occ, contexts, choice, row0=0):
        th = theta[row0:row0 + occ.shape[0]]
        u = draws.uniforms(seed, step, occ.shape[0], row0, occ.device)
        return synth_env.step_rewards(u, th, contexts, choice)

    return _ops(contexts_fn, rewards_fn, n, d, K, draws)


def replay_ops(item_feats: torch.Tensor, cand_ids: torch.Tensor,
               click_probs: torch.Tensor, draws: Draws = HASH_DRAWS
               ) -> EnvOps:
    """The logged-replay kind of the paper-dataset clones: ``item_feats
    [n_items, d]``, each user's queue of slates ``cand_ids [n, max_t, K]``
    and their click probabilities ``click_probs [n, max_t, K]``.  User
    ``u`` reads slate ``min(occ_u, max_t - 1)`` of its queue; only the
    Bernoulli uniforms are drawn."""
    n, max_t, K = cand_ids.shape
    d = item_feats.shape[1]

    def logged(table, occ, row0):
        t = torch.clamp_max(occ, max_t - 1).long()[:, None, None]
        rows = table[row0:row0 + occ.shape[0]]
        return torch.take_along_dim(rows, t, dim=1)[:, 0]      # [n_local, K]

    def contexts_fn(seed, step, occ, row0=0):
        return item_feats[logged(cand_ids, occ, row0).long()]

    def rewards_fn(seed, step, occ, contexts, choice, row0=0):
        u = draws.uniforms(seed, step, occ.shape[0], row0, occ.device)
        return synth_env.click_metrics(u, logged(click_probs, occ, row0),
                                       choice, contexts.dtype)

    return _ops(contexts_fn, rewards_fn, n, d, K, draws)


def default_synthetic_ops(n_users: int, d: int, n_candidates: int,
                          seed: int = 0, n_clusters: int | None = None,
                          device=None) -> EnvOps:
    """A planted clustered env with a mild cluster count (``n_users //
    16``, at least 2) so stages 2 and 3 have structure to find: the
    environment a runtime uses when none is given."""
    if n_clusters is None:
        n_clusters = max(2, n_users // 16)
    env, _ = synth_env.make_synthetic_env(
        seed, n_users=n_users, d=d, n_clusters=n_clusters,
        n_candidates=n_candidates, within_cluster_noise=0.05, device=device)
    return synthetic_ops(env)


def tape_ops(theta: torch.Tensor, contexts: torch.Tensor,
             uniforms: torch.Tensor, users=None) -> EnvOps:
    """The synthetic kind on recorded draws: ``contexts [S, n, K, d]`` and
    Bernoulli ``uniforms [S, n]`` for global rounds ``0..S-1``, rewarded
    against ``theta [n, d]``, and CLUB's ``users [S]`` (host ints) where
    given; the seed is ignored (DCCB's peers are ``draw_peers``').
    Synthetic contexts do not depend on the choices, so a tape of another
    run's draws replays that run exactly."""
    env = synth_env.SyntheticEnv(theta=theta, n_candidates=contexts.shape[2])
    return synthetic_ops(env, tape_draws(uniforms, contexts=contexts,
                                         users=users))
