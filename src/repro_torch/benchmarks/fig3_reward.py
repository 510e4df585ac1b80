"""Paper Figure 3: average reward, best-fixed vs learned, per condition."""
from repro_torch.benchmarks.common import (bar, canonical_results,
                                           save_artifact)


def main(device="cuda", init_params=None) -> dict:
    _, res, _, _ = canonical_results(device, init_params)
    rows = {(r["slo"], r["method"]): r for r in res.rows}
    out = {}
    for slo in ("quality_first", "cheap"):
        for (s, m), r in rows.items():
            if s != slo:
                continue
            out[f"{slo}/{m}"] = r["reward"]
    save_artifact("fig3_reward", out)
    lo = min(out.values())
    for k, v in out.items():
        print(f"{k:40s} {v:+8.4f} {bar(v - lo, 40)}")
    return {"max_reward": max(out.values()),
            "argmax": max(out, key=out.get)}


if __name__ == "__main__":
    print(main())
