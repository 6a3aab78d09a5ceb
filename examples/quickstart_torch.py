"""Quickstart of the PyTorch port: DistCLUB on a planted synthetic
environment, the world and hyper-parameters of ``quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.core import distclub, env, env_ops
from repro_torch.core.types import BanditHyper

N_USERS, D, N_CLUSTERS, K = 128, 16, 8, 20
N_EPOCHS = 8
SEED = 1
# paper hyper-parameters (Table 2), scaled round budgets
HYPER = BanditHyper(alpha=0.03, beta=2.0, gamma=2.4, sigma=8, max_rounds=16,
                    n_candidates=K)


def world(device):
    """128 users in 8 hidden preference clusters."""
    environment, _ = env.make_synthetic_env(
        0, n_users=N_USERS, d=D, n_clusters=N_CLUSTERS, n_candidates=K,
        device=device)
    return env_ops.synthetic_ops(environment)


def report(state, metrics, clusters_per_epoch) -> list[str]:
    """The six lines ``quickstart.py`` prints."""
    reward = float(metrics.reward.sum())
    rand = float(metrics.rand_reward.sum())
    return [
        f"interactions processed : {int(metrics.interactions.sum())}",
        f"cumulative reward      : {reward:.0f}",
        f"random-policy reward   : {rand:.0f}",
        f"reward / random        : {reward / rand:.3f}",
        f"clusters discovered    : {clusters_per_epoch.tolist()}",
        f"comm bytes (stage-2)   : {float(state.comm_bytes):.0f}",
    ]


def main(device="cuda", ops=None):
    """Run the 8 four-stage epochs (stage-1 personalized rounds, stage-2
    clustering, stage-3 cluster-based rounds, stage-4 rebalancing) on
    ``device`` and print the report; ``ops`` replaces the world (a tape of
    recorded draws).  Returns ``(state, metrics, clusters_per_epoch)``."""
    ops = world(device) if ops is None else ops
    result = distclub.run(ops, SEED, HYPER, n_epochs=N_EPOCHS, d=D,
                          device=device)
    for line in report(*result):
        print(line)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
