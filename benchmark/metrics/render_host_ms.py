"""Mean host ms of one `render` call in the window (camera pack, pinned
upload, replay launch, output clones)."""


def read(rec):
    return rec.get("render_host_ms")
