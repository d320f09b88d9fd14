"""Library-level entry points, one per pipeline command (the reference's
`opensfm/actions/`); the port has `match_features` and
`bundle` so far."""
