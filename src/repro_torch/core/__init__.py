"""Host-side core of the port (the software IOTLB)."""
