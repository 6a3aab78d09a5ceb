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
user slice and ``row0`` the global id of the slice's first user.

Determinism under slicing: every draw of ``synthetic_ops`` is keyed by
(seed, step, GLOBAL user id, slot) through a stateless counter hash
(splitmix64 in int64 tensor arithmetic, then Box-Muller for normals),
computed on the device.  So user ``u`` sees the same contexts and the same
Bernoulli draw whatever slice of the user axis it is computed in.
``user_fn`` hashes (seed, step) on the host, so CLUB's loop never waits
for the card; ``peers_fn`` hashes (seed, step, row) on the device.
``tape_ops`` replays given per-round contexts, uniforms and users
instead; the parity tests feed it the reference's own draws.
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


def synthetic_ops(env: synth_env.SyntheticEnv) -> EnvOps:
    n, d, K = env.n_users, env.d, env.n_candidates
    theta = env.theta

    def contexts_fn(seed, step, occ, row0=0):
        return _unit_contexts(seed, step, occ.shape[0], K, d, row0,
                              occ.device)

    def rewards_fn(seed, step, occ, contexts, choice, row0=0):
        th = theta[row0:row0 + occ.shape[0]]
        u = _uniforms(seed, step, occ.shape[0], row0, occ.device)
        return synth_env.step_rewards(u, th, contexts, choice)

    return EnvOps(contexts_fn, rewards_fn, n, d, K,
                  functools.partial(draw_user, n=n), draw_peers)


def tape_ops(theta: torch.Tensor, contexts: torch.Tensor,
             uniforms: torch.Tensor, users=None) -> EnvOps:
    """Replay recorded draws: ``contexts [S, n, K, d]`` and Bernoulli
    ``uniforms [S, n]`` for global rounds ``0..S-1``, rewarded against
    ``theta [n, d]``, and CLUB's ``users [S]`` (host ints) where given;
    the seed is ignored (DCCB's peers are ``draw_peers``').
    Synthetic contexts do not depend on the choices, so a tape of another
    run's draws replays that run exactly."""
    S, n, K, d = contexts.shape

    def contexts_fn(seed, step, occ, row0=0):
        return contexts[step, row0:row0 + occ.shape[0]]

    def rewards_fn(seed, step, occ, ctx, choice, row0=0):
        th = theta[row0:row0 + occ.shape[0]]
        return synth_env.step_rewards(
            uniforms[step, row0:row0 + occ.shape[0]], th, ctx, choice)

    def user_fn(seed, step):
        return int(users[step])

    return EnvOps(contexts_fn, rewards_fn, n, d, K,
                  functools.partial(draw_user, n=n) if users is None
                  else user_fn, draw_peers)
