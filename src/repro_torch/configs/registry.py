"""Import every architecture config so registration side effects run."""
import repro_torch.configs.nemotron_4_15b     # noqa: F401
import repro_torch.configs.qwen2_0_5b         # noqa: F401
import repro_torch.configs.qwen2_5_32b        # noqa: F401
import repro_torch.configs.stablelm_12b       # noqa: F401
import repro_torch.configs.xlstm_1_3b         # noqa: F401
import repro_torch.configs.seamless_m4t_medium  # noqa: F401
import repro_torch.configs.qwen2_vl_2b        # noqa: F401
import repro_torch.configs.granite_moe_3b_a800m  # noqa: F401
import repro_torch.configs.deepseek_moe_16b   # noqa: F401
import repro_torch.configs.recurrentgemma_2b  # noqa: F401
