"""Custom MineRL task specs (counterpart of ``sheeprl_tpu/envs/minerl_envs``)."""
