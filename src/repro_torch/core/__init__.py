"""Host-side core of the port: the software IOTLB, the quantization and
sub-byte packing formats of the packed-weight path, and the page storage
formats of the KV pool."""
