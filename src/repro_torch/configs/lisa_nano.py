"""lisa_nano: a small draft geometry for speculative decoding (host copy
of ``repro/configs/lisa_nano.py``).

The nano draft keeps a lisa_mini target's embedding table, final norm,
answer head and ``seg_proj`` but runs only the first ``DRAFT_LAYERS``
transformer layer(s) of its trunk: a layer-truncated view of the same
weights, so a draft step costs about ``DRAFT_LAYERS / num_layers`` of a
target step with no separate training run. Greedy verification keeps the
output token-exact however often the draft agrees. Use it through
``SpeculativeConfig(draft_params=nano_draft_params(params),
draft_pcfg=CONFIG)``.
"""
import dataclasses

from repro_torch.configs.lisa_mini import CONFIG as MINI

# trunk layers the draft keeps (of lisa_mini's 4)
DRAFT_LAYERS = 1

CONFIG = dataclasses.replace(
    MINI, name="lisa-nano",
    llm=MINI.llm.replace(name="llm-nano", num_layers=DRAFT_LAYERS))


def nano_draft_params(params: dict) -> dict:
    """Slice a target's LISA params down to the nano draft: the first
    ``DRAFT_LAYERS`` LLM layers (leading layer axis of the stacked group
    leaves), shared embed/norm/answer_head/seg_proj. Every leaf is a view
    of the target's tensor: no copy, no extra device memory."""
    def head(tree):
        if isinstance(tree, dict):
            return {k: head(v) for k, v in tree.items()}
        return tree[:DRAFT_LAYERS]

    llm = params["llm"]
    return {
        "llm": {
            "embed": llm["embed"],
            "groups": [head(llm["groups"][0])],
            "norm": llm["norm"],
            "answer_head": llm["answer_head"],
        },
        "seg_proj": params["seg_proj"],
    }
