from chromosome3d.cli import main

raise SystemExit(main())
