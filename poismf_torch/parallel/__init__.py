"""Row-sharded multi-device training on ``torch.distributed``: one process
per device, each solving its own contiguous range of rows
(:mod:`.mesh`, :mod:`.ell_mesh`)."""
