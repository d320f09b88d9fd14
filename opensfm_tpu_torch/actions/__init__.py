"""Library-level entry points, one per pipeline command (the reference's
`opensfm/actions/`): the eight stages of `run_all`, `bundle`,
`reconstruct_from_prior`, `extend_reconstruction` and `create_rig`."""
