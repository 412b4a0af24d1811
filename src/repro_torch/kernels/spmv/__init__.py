"""Blocked-ELL and CSR-stripe SpMV."""
