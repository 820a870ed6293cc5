"""Tiny stand-ins of the benchmark's configurations and mixes, for the
CPU tests: the published files with every width cut, the same keys and
rules; outputs short enough that a window of a second or two on a busy
CPU finishes requests to judge."""
from bench.lib import spec

MIXES = {
    "reason": dict(name="reason", loop="closed", clients=8, slots=8,
                   max_len=256, page_size=16,
                   prompt=dict(dist="loguniform", min=8, max=64),
                   output=dict(dist="uniform", min=8, max=24),
                   sampled=dict(temperature=0.7, top_p=0.95, top_k=0),
                   greedy_share=0.5, block=16, check_tokens=256,
                   check_sampled_tokens=256),
    "chat": dict(name="chat", loop="closed", clients=64, slots=64,
                 max_len=192, page_size=16,
                 prompt=dict(dist="loguniform", min=16, max=128),
                 output=dict(dist="uniform", min=8, max=24),
                 sampled=None, greedy_share=1.0, block=16,
                 check_tokens=512, check_requests=16, check_slice=8),
}


def config(name: str) -> dict:
    cfg = spec.config(name)
    pub = cfg["published"]
    if cfg["as_run"]["block"] == "qwen2":
        pub.update(num_hidden_layers=2, hidden_size=64,
                   intermediate_size=128, num_attention_heads=4,
                   num_key_value_heads=2, vocab_size=500)
    else:
        pub.update(n_layers=2, d_model=64, n_heads=4, vocab_size=500)
        pub["attn_config"] = dict(pub["attn_config"], kv_n_heads=2)
        pub["ffn_config"] = dict(pub["ffn_config"], ffn_hidden_size=96)
    cfg["as_run"]["head_dim"] = 16
    return cfg


CELLS = {"reason": ("qwen2.5-3b", "qwen2.5-3b.reason"),
         "chat": ("dbrx-132b", "dbrx-132b.chat")}
