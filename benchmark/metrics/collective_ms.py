"""Device ms of NCCL kernels a band frame on rank 0."""


def read(rec):
    return rec.get("collective_ms")
