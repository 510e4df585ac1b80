"""Paper Figure 1: learned action distributions per SLO × objective."""
from repro_torch.benchmarks.common import (bar, canonical_results,
                                           save_artifact)

ACTION_LABELS = ["a0 k=2 guarded", "a1 k=5 guarded", "a2 k=10 guarded",
                 "a3 k=5 auto", "a4 refuse"]


def main(device="cuda", init_params=None) -> dict:
    _, res, extras, _ = canonical_results(device, init_params)
    dists = extras["action_dists"]
    save_artifact("fig1_action_dist", dists)
    for key, dist in dists.items():
        print(f"\n{key}")
        for lbl, p in zip(ACTION_LABELS, dist):
            print(f"  {lbl:16s} {p:5.3f} {bar(p)}")
    collapse = dists.get("cheap/argmax_ce", [0] * 5)[4]
    return {"cheap_ce_refuse_share": collapse,
            "quality_ce_a0_share": dists["quality_first/argmax_ce"][0]}


if __name__ == "__main__":
    print(main())
