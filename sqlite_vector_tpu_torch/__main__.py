from sqlite_vector_tpu_torch.cli import main

raise SystemExit(main())
