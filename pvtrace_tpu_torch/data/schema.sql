-- SQLite DDL for simulation event persistence.
-- Column contract matches the reference pvtrace schema (data/schema.sql)
-- so existing count/spectrum/time queries keep working.

CREATE TABLE ray (
    throw_id NOT NULL,   -- increments each time a light source throws a new ray
    x DOUBLE,            -- position x
    y DOUBLE,            -- position y
    z DOUBLE,            -- position z
    i DOUBLE,            -- direction x
    j DOUBLE,            -- direction y
    k DOUBLE,            -- direction z
    wavelength DOUBLE,   -- wavelength / nm
    source TEXT,         -- emitting light source or luminophore
    travelled DOUBLE,    -- total distance travelled / cm
    duration DOUBLE      -- total time since the start of the simulation / s
);

CREATE TABLE event (
    ray_id INTEGER NOT NULL,  -- the ray causing this event
    kind TEXT,                -- Event enum name, e.g. GENERATE, EMIT
    component TEXT,           -- component name at this event
    hit TEXT,                 -- hit node name
    container TEXT,           -- container node name
    adjacent TEXT,            -- adjacent node name
    facet TEXT,               -- facet identifier
    ni DOUBLE,                -- surface normal x
    nj DOUBLE,                -- surface normal y
    nk DOUBLE,                -- surface normal z
    FOREIGN KEY(ray_id) REFERENCES ray(rowid)
);
