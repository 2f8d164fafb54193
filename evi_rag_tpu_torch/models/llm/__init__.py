"""Language models of the reasoner: Moonlight-16B-A3B (``deepseek_v3``:
multi-head latent attention and a sparse mixture of experts)."""
