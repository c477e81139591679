"""Host-side core of the port: the software IOTLB, and the quantization
and sub-byte packing formats of the packed-weight path."""
