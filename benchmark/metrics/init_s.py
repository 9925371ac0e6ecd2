"""Host seconds of the pipeline's constructor (scene pack, atlas, IBL)."""


def read(rec):
    return rec.get("init_s")
