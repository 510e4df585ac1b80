"""Beyond paper (addresses limitation §8 'point estimates only'):
Table-1 headline metrics across 5 corpus/policy seeds, mean ± std."""
import numpy as np

from repro_torch.benchmarks.common import initial, save_artifact
from repro_torch.core.actions import SLO_PROFILES
from repro_torch.core.config import RouterConfig, TestbedConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.metrics import best_fixed_action, evaluate_actions
from repro_torch.core.offline_log import build_testbed
from repro_torch.core.policy import policy_actions, train_policy

N_SEEDS = 5


def main(device="cuda", init_params=None) -> dict:
    resolve_device(device)
    metrics = {"quality_ce_reward": [], "quality_bf_reward": [],
               "cheap_ce_refusal": [], "cheap_gap": []}
    for seed in range(N_SEEDS):
        cfg = TestbedConfig(n_train=500, n_eval=150, n_paragraphs=400,
                            seed=seed, router=RouterConfig(n_epochs=20,
                                                           seed=seed))
        _, _, _, train_log, eval_log = build_testbed(cfg)
        for slo, keys in (("quality_first", ("quality_ce_reward",
                                             "quality_bf_reward")),
                          ("cheap", ("cheap_ce_refusal", "cheap_gap"))):
            p = SLO_PROFILES[slo]
            tr = train_policy(train_log, train_log.rewards(p), cfg.router,
                              objective="argmax_ce",
                              init_params=initial(init_params, cfg.router),
                              device=device)
            acts = policy_actions(tr.params, eval_log.states, cfg.router)
            rep = evaluate_actions(eval_log, acts, p, "ce")
            _, bf = best_fixed_action(eval_log, p)
            if slo == "quality_first":
                metrics["quality_ce_reward"].append(rep.reward)
                metrics["quality_bf_reward"].append(bf.reward)
            else:
                metrics["cheap_ce_refusal"].append(rep.refusal_rate)
                metrics["cheap_gap"].append(rep.reward - bf.reward)

    out = {k: {"mean": float(np.mean(v)), "std": float(np.std(v)),
               "values": [round(float(x), 4) for x in v]}
           for k, v in metrics.items()}
    save_artifact("seeds_ablation", out)
    for k, v in out.items():
        print(f"{k:22s} {v['mean']:+.4f} ± {v['std']:.4f}  {v['values']}")
    return {k: round(v["mean"], 4) for k, v in out.items()}


if __name__ == "__main__":
    print(main())
