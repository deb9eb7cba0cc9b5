"""Random-number helpers shared by the host seeding and the plain trace."""
