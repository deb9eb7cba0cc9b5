"""Seeding, kernel-row packing, the persistent trace and the simulator."""
