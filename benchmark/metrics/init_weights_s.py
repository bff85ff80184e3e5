"""init_weights_s: wall seconds of the facade's numpy draw of every weight
(the program's ``init_weights`` span in ``EgoNet.__init__``), a part of
``setup_s`` that ``load_state`` then overwrites.  Read from the program's
always-on span totals (``egonet_tpu_torch/utils/profiling.totals``) when
the readers run: a run builds one facade, in set-up, so the total is its
one draw.  Nothing where the program keeps no totals or drew no
weights."""


def read(record):
    from egonet_tpu_torch.utils import profiling
    totals = getattr(profiling, "totals", None)
    row = totals().get("init_weights") if totals is not None else None
    return row[1] if row else None
