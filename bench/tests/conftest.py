"""The harness's tests run small models on the CPU; one thread each keeps
them quick beside other test processes on the same cores.

`bench_root` is a checkout's root whose BENCHMARK.json adds two serving
cells, one a configuration, to the committed manifest, with their files
beside the committed ones: the serving harness has no cell of its own yet
(PERF.md), and this is how a later change would add one, by data alone."""
import json

import pytest
import torch

from bench.lib import manifest as mf

# cell -> (configuration, cell file, traffic mix); the sizes are cut
# further by each test's overrides
SERVE_CELLS = {
    "deepseek.serve": ("deepseek-v2-lite-16b", {"mean_logit_gap": 0.08}),
    "danube.serve": ("h2o-danube-1.8b", {"logit_gap": 0.5}),
}
MIX = {"clients": 8,
       "prompt": {"dist": "loguniform", "min": 8, "max": 60},
       "output": {"dist": "loguniform", "min": 4, "max": 16}}
SERVE_LAYER = ("engine_host_ms.serve", "decode_lanes.serve",
               "ttft_p95_ms.queue", "kv_used_share.serve",
               "decode_device_ms.serve", "prefill_device_ms.serve",
               "gpp_matmul_roofline.serve", "paged_attention_roofline.serve",
               "idle_share.serve", "mfu.serve")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    bench = root / "bench"
    bench.mkdir()
    for d in ("configs", "metrics"):
        (bench / d).symlink_to(mf.BENCH / d)
    for d in ("workloads", "traffic"):
        (bench / d).mkdir()
        for f in (mf.BENCH / d).iterdir():
            (bench / d / f.name).symlink_to(f)
    man = mf.manifest()
    have = {c["name"] for c in man["configs"]}
    cells = list(SERVE_CELLS)
    for name, (config, limits) in SERVE_CELLS.items():
        if config not in have:
            conf = mf.load_json(mf.BENCH / "configs" / f"{config}.json")
            man["configs"].append({
                "name": config, "source": conf["bench"]["source"],
                "file": f"bench/configs/{config}.json",
                "reduced": sorted(conf["bench"]["departures"]),
                "why": "test"})
            have.add(config)
        man["workloads"].append({"name": name, "config": config,
                                 "traffic": "small", "chips": 1,
                                 "why": "test"})
        (bench / "workloads" / f"{name}.json").write_text(json.dumps({
            "kind": "serve",
            "engine": {"max_len": 128, "block_size": 16,
                       "token_budget": 48},
            "trace_from_step": 3, "trace_steps": 4,
            "check": {"requests": 4, "min_tokens": 10, "limits": limits}}))
    (bench / "traffic" / "small.json").write_text(json.dumps(MIX))
    for n, better in (("serve_tok_s", "higher"), ("itl_p95_ms", "lower")):
        man["end_to_end"].append({"name": n, "unit": "x", "better": better,
                                  "bound": 0.25, "source": "host_clock",
                                  "workloads": cells})
    for n in SERVE_LAYER + ("gpp_matmul_grouped_roofline.serve",):
        man["per_layer"].append({
            "name": n, "unit": "x", "better": "higher",
            "source": "device_trace", "layer": "test",
            "moves": "serve_tok_s",
            "workloads": cells if n in SERVE_LAYER else ["deepseek.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root
