"""Data-preparation scripts of the port (counterparts of
scripts/data_preparation/), each run as `python -m
femasr_torch.scripts.<name>` with its counterpart's arguments:
create_shard, extract_subimages, generate_meta_info,
generate_bicubic_lr and back_projection."""
