"""Library-level entry points, one per pipeline command (the reference's
`opensfm/actions/`); this slice of the port has `bundle`."""
