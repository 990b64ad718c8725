"""One runner a kind of traffic (a traffic file's ``kind``): ``run(ctx)``
runs the set-up, the window and the check of a cell."""
