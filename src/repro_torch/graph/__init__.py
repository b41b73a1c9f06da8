"""Graph substrate: host-side CSR (numpy) and the device-side ELL layout."""
