"""The LM substrate's models, ported from ``repro.models``: the shared
schema machinery and norms (``common``), the FFN variants (``ffn``), GQA
attention with its KV caches (``attention``), the MoE layer (``moe``),
the mLSTM, sLSTM and RG-LRU blocks with their states (``recurrent``) and
the model assembly (``model``)."""
